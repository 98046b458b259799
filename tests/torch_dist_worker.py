"""One rank of a torch.distributed (gloo) world for tests/test_torch_zero.py.

    python tests/torch_dist_worker.py SCENARIO RANK WORLD INIT_URL IN.npz OUT.npz

It imports torch and ray_tpu_torch only, reads its inputs from IN.npz (trees
flattened to "a/b/c" keys), joins the group through INIT_URL (a file://
rendezvous), runs SCENARIO and writes this rank's results to OUT.npz.
"""

import copy
import sys

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.models.convert import flatten, unflatten
from ray_tpu_torch.train import setup_torch_distributed, zero


def load_tree(data, prefix):
    keys = [k for k in data.files if k.startswith(prefix + "/")]
    paths = [tuple(k[len(prefix) + 1:].split("/")) for k in keys]
    return unflatten(paths, [torch.from_numpy(np.array(data[k])) for k in keys])


def put_tree(out, prefix, tree):
    for path, t in zip(*flatten(tree)):
        out["/".join((prefix, *path))] = t.detach().cpu().numpy().copy()


def zero_update(rank, world, data, out):
    """build_zero_update over 3 given grads, on the default group or a 1-D
    DeviceMesh; the logical state after, and one more step from that state
    loaded into a fresh optimizer against the running one."""
    mesh = None
    if int(data["use_mesh"]):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    params = load_tree(data, "params")
    make = tfm.adamw(float(data["lr"]))
    update, sharder = zero.build_zero_update(params, mesh, axis="data")
    opt = zero.init_opt_state(make, params, mesh, "data")
    struct = sharder.shard_struct()
    shards = opt.param_groups[0]["params"]
    assert [(s.shape, s.dtype) for s in struct.values()] == [(s.shape, s.dtype) for s in shards]
    assert all(torch.equal(a, b) for a, b in zip(
        flatten(sharder.unflatten(sharder.flatten(params)))[1], flatten(params)[1]))
    plain = make([t.clone() for t in flatten(params)[1]])
    for t, g in zip(plain.param_groups[0]["params"], flatten(load_tree(data, "grads0"))[1]):
        t.grad = g
    plain.step()
    out["bytes_plain"] = np.int64(zero.per_device_bytes(plain))
    for k in range(3):
        update(params, opt, load_tree(data, f"grads{k}"))
    out["bytes_sharded"] = np.int64(zero.per_device_bytes(opt))
    assert zero.per_device_bytes(params) == 97 * 4  # a tree: every leaf on the CPU
    put_tree(out, "params", params)
    logical = sharder.to_logical(opt)
    put_tree(out, "logical", logical)
    fresh = zero.init_opt_state(make, params, mesh, "data")
    sharder.from_logical(logical, fresh)
    twin = tfm.map_tree(torch.clone, params)
    grads = load_tree(data, "grads0")
    # place_opt: the optimizer's own state_dict at the same world size, as a
    # file would give it back (a copy)
    placed = zero.init_opt_state(make, params, mesh, "data")
    sharder.place_opt(placed, copy.deepcopy(opt.state_dict()))
    triplet = tfm.map_tree(torch.clone, params)
    update(params, opt, grads)
    update(twin, fresh, grads)
    update(triplet, placed, grads)
    out["resumed_equal"] = np.bool_(all(
        torch.equal(a, b) and torch.equal(a, c)
        for a, b, c in zip(flatten(params)[1], flatten(twin)[1], flatten(triplet)[1])))


def zero_train(rank, world, data, out):
    """build_train_step(zero_axis="data") on tiny() in fp32 from the given
    params, each rank on its slice of the batch; and the plain step's
    optimizer bytes for comparison."""
    cfg = tfm.tiny(dtype=torch.float32, attn_impl="full")
    make = tfm.adamw(float(data["lr"]))
    init, step = tfm.build_train_step(cfg, make, device="cpu", zero_axis="data")
    params, opt = init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t, src in zip(flatten(params)[1], flatten(load_tree(data, "params"))[1]):
            t.copy_(src)
    tokens = torch.from_numpy(data["tokens"])
    b = tokens.shape[0] // world
    mine = tokens[rank * b:(rank + 1) * b]
    out["losses"] = np.array([float(step(params, opt, mine)) for _ in range(int(data["steps"]))])
    put_tree(out, "params", params)
    out["bytes_sharded"] = np.int64(zero.per_device_bytes(opt))
    init_u, step_u = tfm.build_train_step(cfg, make, device="cpu")
    params_u, opt_u = init_u(torch.Generator().manual_seed(0))
    step_u(params_u, opt_u, mine)
    out["bytes_plain"] = np.int64(zero.per_device_bytes(opt_u))


def main():
    scenario, rank, world, url, in_path, out_path = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    info = setup_torch_distributed(rank, world, url, backend="gloo", init_timeout_s=60)
    assert info["process_index"] == rank and info["process_count"] == world, info
    data = np.load(in_path)
    out = {}
    try:
        {"zero_update": zero_update, "zero_train": zero_train}[scenario](rank, world, data, out)
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)


if __name__ == "__main__":
    main()
