"""ray_tpu_torch.data: lazy distributed datasets with streaming execution,
the port of ray_tpu.data (re-design of the reference's Ray Data, SURVEY.md
§2c). Blocks are dicts of numpy columns (data/block.py); batches reach the
card as torch tensors through `DataIterator.iter_device_batches`. Nothing
here imports pyarrow or pandas but the file readers and writers and the
"pandas"/"pyarrow" batch formats, inside the call."""

from .block import Block, BlockAccessor
from .dataset import (
    Dataset,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_csv,
    read_json,
    read_parquet,
)
from .feed import ChannelDataIterator, ChannelFeed, make_channel_feeds
from .iterator import DataIterator, SplitStreams

__all__ = [
    "Block", "BlockAccessor", "ChannelDataIterator", "ChannelFeed",
    "Dataset", "DataIterator", "SplitStreams", "from_items", "from_numpy",
    "from_pandas", "make_channel_feeds", "range", "read_csv", "read_json",
    "read_parquet",
]
