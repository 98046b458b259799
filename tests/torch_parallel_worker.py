"""One rank of a torch.distributed (gloo) world that serves the parallel
tests (tests/test_torch_parallel*.py, through tests/torch_world.py).

    python tests/torch_parallel_worker.py RANK WORLD INIT_URL

It imports torch and ray_tpu_torch only, joins the group, then reads one
JSON command per line on stdin, {"scenario", "in", "out"}: it loads the
inputs from the npz file "in" (trees flattened to "a/b/c" keys), runs the
scenario on this rank, writes this rank's results to "out" and answers one
line, "@@ok" or "@@error <message>". End of input ends the process.
"""

import json
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import parallel as par
from ray_tpu_torch.models import transformer as tfm
from ray_tpu_torch.models.convert import flatten
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.train import setup_torch_distributed
from torch_dist_worker import load_tree, put_tree


def _t(data, key):
    return torch.from_numpy(np.array(data[key]))


def _axes(data):
    """The mesh's axis sizes from the inputs' "axes/<name>" entries."""
    return {k.split("/", 1)[1]: int(data[k]) for k in data.files if k.startswith("axes/")}


def _mesh(data):
    return par.build_device_mesh(axis_sizes=_axes(data))


def mesh_cases(rank, world, data, out):
    """MeshSpec resolution on the world, axis order, bad sizes, the
    coordinate helpers."""
    m = par.build_device_mesh(par.MeshSpec(data=-1, tensor=2))
    for k, v in par.mesh_shape(m).items():
        out[f"shape/{k}"] = np.int64(v)
    out["axis_names"] = np.array(list(m.mesh_dim_names))
    out["data_parallel_rank"] = np.int64(par.data_parallel_rank(m))
    out["host_local_device_count"] = np.int64(par.host_local_device_count(use_gpu=False))
    for name, fn in (("bad_sizes", lambda: par.build_device_mesh(par.MeshSpec(data=3, tensor=2))),
                     ("two_wild", lambda: par.build_device_mesh(par.MeshSpec(data=-1, seq=-1))),
                     ("single", par.single_device_mesh)):
        try:
            fn()
            out[f"raised/{name}"] = np.bool_(False)
        except ValueError:
            out[f"raised/{name}"] = np.bool_(True)


def collective_grads(rank, world, data, out):
    """Each collective on this rank's x with loss sum(op(x) * w): the output
    and x's gradient."""
    mesh = par.build_device_mesh(axis_sizes={"seq": world})
    x, w = _t(data, "x")[rank], _t(data, "w")[rank]
    ops = {
        "psum": lambda x: par.psum(x, mesh, "seq"),
        "pmean": lambda x: par.pmean(x, mesh, "seq"),
        "ring": lambda x: par.ring_permute(x, mesh, "seq", shift=1),
        "ring_back": lambda x: par.ring_permute(x, mesh, "seq", shift=-1),
        "pbroadcast": lambda x: par.pbroadcast(x, mesh, "seq", root=1),
        "all_gather": lambda x: par.all_gather(x, mesh, "seq", gather_dim=1),
        "reduce_scatter": lambda x: par.reduce_scatter(x, mesh, "seq", scatter_dim=1),
        "all_to_all": lambda x: par.all_to_all(x, mesh, "seq", split_dim=1, concat_dim=0),
    }
    for name, op in ops.items():
        xi = x.clone().requires_grad_()
        y = op(xi)
        wy = w if name not in ("all_gather", "reduce_scatter", "all_to_all") else _t(
            data, f"w_{name}")[rank]
        (y * wy).sum().backward()
        out[f"y/{name}"] = y.detach().numpy()
        out[f"g/{name}"] = xi.grad.numpy()
    xi = x.clone().requires_grad_()
    out["y/pmax"] = par.pmax(xi, mesh, "seq").detach().numpy()
    try:
        par.pmax(xi, mesh, "seq").sum().backward()
        out["pmax_grad_raised"] = np.bool_(False)
    except NotImplementedError:
        out["pmax_grad_raised"] = np.bool_(True)
    out["one_hot"] = col.one_hot_rank(mesh, "seq").numpy()
    out["axis_index"] = np.int64(par.axis_index(mesh, "seq"))
    out["axis_size"] = np.int64(par.axis_size(mesh, "seq"))


def shard_params(rank, world, data, out):
    """shard_tree on the given mesh: each leaf's spec and placements (as
    text) and this rank's local shard; the same of replicate_tree."""
    mesh = _mesh(data)
    params = load_tree(data, "params")
    sharded = par.shard_tree(params, mesh)
    specs = par.sharding.tree_specs(params, mesh)
    for path, leaf in zip(*_flat(sharded)):
        key = "/".join(path)
        out[f"local/{key}"] = leaf.to_local().numpy()
        out[f"placements/{key}"] = np.array(repr(tuple(leaf.placements)))
    for path, spec in zip(*_flat(specs)):
        out[f"spec/{'/'.join(path)}"] = np.array(repr(tuple(spec)))
    for path, leaf in zip(*_flat(par.replicate_tree(params, mesh))):
        key = "/".join(path)
        out[f"replicated/{key}"] = leaf.to_local().numpy()
        out[f"replicated_placements/{key}"] = np.array(repr(tuple(leaf.placements)))


def _flat(tree, prefix=()):
    paths, leaves = [], []
    for k, v in tree.items():
        if isinstance(v, dict):
            p, lv = _flat(v, prefix + (k,))
            paths += p
            leaves += lv
        else:
            paths.append(prefix + (k,))
            leaves.append(v)
    return paths, leaves


def shard_batch_case(rank, world, data, out):
    """shard_batch of this rank's rows of a global batch on data=2, fsdp=2;
    then on seq=world, where the batch axes cannot split it."""
    mesh = _mesh(data)
    x = _t(data, "x")
    n = x.shape[0] // world
    got = par.shard_batch({"x": x[rank * n:(rank + 1) * n]}, mesh)["x"]
    out["placements"] = np.array(repr(tuple(got.placements)))
    out["full"] = got.full_tensor().numpy()
    out["local"] = got.to_local().numpy()
    try:
        par.shard_batch({"x": x[:n]}, par.build_device_mesh(axis_sizes={"seq": world}))
        out["indivisible_raised"] = np.bool_(False)
    except ValueError:
        out["indivisible_raised"] = np.bool_(True)


def _seq_shard(t, rank, world):
    n = t.shape[1] // world
    return t[:, rank * n:(rank + 1) * n].contiguous()


def seq_attention(rank, world, data, out):
    """ring_attention or ulysses_attention on this rank's sequence shard;
    with "target" also the gradients of sum((o - target)^2)."""
    mesh = par.build_device_mesh(axis_sizes={"seq": world})
    fn = {"ring": par.ring_attention, "ulysses": par.ulysses_attention}[str(data["impl"])]
    q, k, v = (_seq_shard(_t(data, n), rank, world).requires_grad_() for n in "qkv")
    o = fn(q, k, v, mesh, causal=bool(data["causal"]))
    out["o"] = o.detach().numpy()
    if "target" in data.files:
        ((o - _seq_shard(_t(data, "target"), rank, world)) ** 2).sum().backward()
        for n, t in zip("qkv", (q, k, v)):
            out[f"d{n}"] = t.grad.numpy()


def _stage_fn(p, x):
    y = x @ p["w"]
    return torch.tanh(y + p["b"]) if "b" in p else torch.tanh(y)


def pipeline_forward(rank, world, data, out):
    """pipeline_apply of the stacked stage params over "stage"."""
    mesh = _mesh(data)
    stacked = load_tree(data, "stages")
    params = par.shard_stage_params(stacked, mesh)
    out["y"] = par.pipeline_apply(_stage_fn, params, _t(data, "x"), mesh).numpy()


def pipeline_grad(rank, world, data, out):
    """The gradient of mean(pipeline_apply(...)^2) w.r.t. the stacked
    params, with and without remat."""
    mesh = _mesh(data)
    for remat in (True, False):
        stacked = load_tree(data, "stages")
        for t in tfm.tree_leaves(stacked):
            t.requires_grad_()
        y = par.pipeline_apply(_stage_fn, par.shard_stage_params(stacked, mesh), _t(data, "x"),
                               mesh, remat=remat)
        (y ** 2).mean().backward()
        out[f"g/{remat}/w"] = stacked["w"].grad.numpy()


def _model(data):
    cfg = tfm.tiny(dtype=torch.float32, **json.loads(str(data["cfg"])))
    params = load_tree(data, "params")
    for t in tfm.tree_leaves(params):
        t.requires_grad_()
    return cfg, params


def model_loss(rank, world, data, out):
    """forward (logits of this rank's part) and next_token_loss with every
    leaf's gradient, on the given mesh; "pipelined" runs forward_pipelined
    and next_token_loss_pipelined instead."""
    mesh = _mesh(data)
    cfg, params = _model(data)
    tokens = _t(data, "tokens")
    if bool(data["pipelined"]):
        with torch.no_grad():
            out["logits"] = tfm.forward_pipelined(params, tokens, cfg, mesh).numpy()
        loss = tfm.next_token_loss_pipelined(params, tokens, cfg, mesh)
    else:
        with torch.no_grad():
            out["logits"] = tfm.forward(params, tokens, cfg, mesh).numpy()
        loss = tfm.next_token_loss(params, tokens, cfg, mesh)
    loss.backward()
    out["loss"] = np.float64(loss.item())
    put_tree(out, "grads", tfm.map_tree(lambda t: t.grad, params))


def train_steps(rank, world, data, out):
    """build_train_step's plain step with a mesh: 3 AdamW steps' losses, the
    first step's gradients and the params after."""
    mesh = _mesh(data)
    cfg, start = _model(data)
    init, step = tfm.build_train_step(cfg, tfm.adamw(float(data["lr"])), device="cpu", mesh=mesh)
    # init_state lays params out by shard_tree: replicated on this mesh
    params, opt = init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t, src in zip(flatten(params)[1], flatten(start)[1]):
            par.sharding.local_shard(t).copy_(src)
    tokens = _t(data, "tokens")
    losses = [float(step(params, opt, tokens))]
    # the step leaves each leaf's gradient in .grad until the next step
    _put_local(out, "grads", tfm.map_tree(lambda t: t.grad, params))
    losses += [float(step(params, opt, tokens)) for _ in range(2)]
    out["losses"] = np.array(losses)
    _put_local(out, "params", params)


def _put_local(out, prefix, tree):
    """Each leaf's local shard (a DTensor's to_local, a tensor itself)."""
    put_tree(out, prefix, tfm.map_tree(par.sharding.local_shard, tree))


def tp_model(rank, world, data, out):
    """The model on params laid out by shard_tree on the given mesh: this
    rank's logits, the loss (with the inputs' "mask", if any) and every
    leaf's gradient shard; whether each gradient has its param's
    placements; how many tensors autograd saved for the loss's backward
    have a whole-vocab last dim, and how many are the whole [vocab, d]
    table."""
    mesh = _mesh(data)
    cfg, params = _model(data)
    params = par.shard_tree(params, mesh)
    tokens = _t(data, "tokens")
    mask = _t(data, "mask") if "mask" in data.files else None
    with torch.no_grad():
        out["logits"] = tfm.forward(params, tokens, cfg, mesh).numpy()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tfm.next_token_loss(params, tokens, cfg, mesh, mask=mask)
    out["saved_whole_vocab"] = np.int64(sum(1 for sh in saved
                                            if sh and sh[-1] == cfg.vocab_size))
    out["saved_whole_table"] = np.int64(sum(1 for sh in saved
                                            if sh == (cfg.vocab_size, cfg.d_model)))
    out["saved_count"] = np.int64(len(saved))
    loss.backward()
    out["loss"] = np.float64(loss.item())
    _put_local(out, "grads", tfm.map_tree(lambda t: t.grad, params))
    _put_local(out, "local", params)
    out["same_placements"] = np.bool_(all(
        t.grad.placements == t.placements for t in tfm.tree_leaves(params)))


def tp_train_steps(rank, world, data, out):
    """build_train_step with the mesh on the caller's sharded params: 3 AdamW
    steps' losses, the first step's gradient shards and the param shards
    after."""
    mesh = _mesh(data)
    cfg, start = _model(data)
    init, step = tfm.build_train_step(cfg, tfm.adamw(float(data["lr"])), device="cpu", mesh=mesh)
    params, opt = init(torch.Generator().manual_seed(0), params=par.shard_tree(start, mesh))
    tokens = _t(data, "tokens")
    losses = [float(step(params, opt, tokens))]
    _put_local(out, "grads", tfm.map_tree(lambda t: t.grad, params))
    losses += [float(step(params, opt, tokens)) for _ in range(2)]
    out["losses"] = np.array(losses)
    _put_local(out, "params", params)


def moe_case(rank, world, data, out):
    """moe_apply on this rank's token block with params laid out by
    EXPERT_RULES (under a "moe" key, the rules composed with the
    transformer's): y, the aux loss, and the gradients of sum(y * w) + aux
    for x and each param shard."""
    from ray_tpu_torch.models import moe

    mesh = _mesh(data)
    cfg = moe.MoEConfig(**json.loads(str(data["cfg"])))
    rules = moe.EXPERT_RULES + par.TRANSFORMER_RULES
    params = par.shard_tree({"moe": load_tree(data, "params")}, mesh, rules)["moe"]
    for t in params.values():
        t.requires_grad_()
    sizes = par.mesh_shape(mesh)
    axes = tuple(a for a in moe.TOKEN_AXES if sizes[a] > 1)
    g, n = (col.axis_index(mesh, axes), col.axis_size(mesh, axes)) if axes else (0, 1)
    x, w = (_t(data, k) for k in ("x", "w"))
    rows = slice(g * x.shape[0] // n, (g + 1) * x.shape[0] // n)
    x = x[rows].clone().requires_grad_()
    capacity = int(data["capacity"]) if "capacity" in data.files else None
    y, aux = moe.moe_apply(params, x, cfg, capacity=capacity, mesh=mesh)
    ((y * w[rows]).sum() + aux).backward()
    out["y"], out["aux"], out["dx"] = y.detach().numpy(), np.float64(aux.item()), x.grad.numpy()
    out["rows"] = np.array([rows.start, rows.stop])
    _put_local(out, "grads", {k: t.grad for k, t in params.items()})
    out["same_placements"] = np.bool_(all(
        t.grad.placements == t.placements for t in params.values()))


SCENARIOS = {f.__name__: f for f in (mesh_cases, collective_grads, shard_params,
                                     shard_batch_case, seq_attention, pipeline_forward,
                                     pipeline_grad, model_loss, train_steps, tp_model,
                                     tp_train_steps, moe_case)}


def main():
    rank, world, url = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    setup_torch_distributed(rank, world, url, backend="gloo", init_timeout_s=60)
    try:
        for line in sys.stdin:
            cmd = json.loads(line)
            try:
                out = {}
                SCENARIOS[cmd["scenario"]](rank, world, np.load(cmd["in"]), out)
                np.savez(cmd["out"], **out)
                reply = "@@ok"
            except Exception as e:  # noqa: BLE001 - reported to the test, which fails
                traceback.print_exc()
                reply = f"@@error {type(e).__name__}: {e}".replace("\n", " ")
            print(reply, flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
