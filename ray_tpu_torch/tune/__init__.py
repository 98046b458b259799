"""ray_tpu_torch.tune: hyperparameter search and trial orchestration (the
counterpart of ray_tpu.tune, a re-design of the reference's Ray Tune).
Trials run in the trainer's worker actors on the in-process runtime; a
trainable is a function or a TorchTrainer."""

from .schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import (
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from .tuner import ResultGrid, Trial, TuneConfig, Tuner, get_checkpoint, report

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "ASHAScheduler", "AsyncHyperBandScheduler", "BasicVariantGenerator",
    "FIFOScheduler", "MedianStoppingRule", "PopulationBasedTraining",
    "ResultGrid", "Searcher", "TPESearcher", "Trial", "TrialScheduler", "TuneConfig",
    "Tuner", "choice", "get_checkpoint", "grid_search", "lograndint",
    "loguniform", "quniform", "randint", "report", "sample_from", "uniform",
]
