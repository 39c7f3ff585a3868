"""Multi-process helpers of the port's data-parallel tests: start gloo
ranks on the CPU and run a function on each, and the functions the
ranks run. JAX-free: the ranks import torch and the port only.

`Ranks(fn, n, tmp_path, *args)` spawns n processes (torch.
multiprocessing, method 'spawn'), each with one intra-op thread, joins
them into a gloo process group on a free localhost port and calls
fn(rank, *args); its join() returns the ranks' results in rank order
(each saved with torch.save), so a test computes its reference while the
ranks run. `run_ranks` starts and joins. A rank that raises makes join
raise, and the other ranks are stopped.
"""

import contextlib
import copy
import datetime
import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port():
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, out, env, args):
    torch.set_num_threads(1)
    os.environ.update(env)
    if "RANK" not in env:
        dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=180))
    try:
        result = fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, os.path.join(out, "rank%d.pt" % rank))


class Ranks:
    """n processes running fn(rank, *args) on gloo ranks, started at once;
    join() waits for them and returns their results in rank order. With
    torchrun_env the ranks get torchrun's variables instead of an
    initialised group."""

    def __init__(self, fn, n, tmp_path, *args, torchrun_env=False):
        self.n, self.out = n, str(tmp_path)
        port = free_port()
        envs = [{} for _ in range(n)]
        if torchrun_env:
            envs = [{"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": str(n),
                     "RANK": str(r), "LOCAL_RANK": str(r)} for r in range(n)]
        self.ctx = mp.start_processes(_entry_by_rank, args=(fn, n, port, self.out, envs, args),
                                      nprocs=n, join=False, start_method="spawn")

    def join(self, timeout=900):
        deadline = time.monotonic() + timeout
        while not self.ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in self.ctx.processes:
                    p.terminate()
                raise TimeoutError("the ranks did not finish in %d s" % timeout)
        return [torch.load(os.path.join(self.out, "rank%d.pt" % r), weights_only=False)
                for r in range(self.n)]


def run_ranks(fn, n, tmp_path, *args, torchrun_env=False):
    """fn(rank, *args) on n gloo ranks: their results in rank order."""
    return Ranks(fn, n, tmp_path, *args, torchrun_env=torchrun_env).join()


def _entry_by_rank(rank, fn, world, port, out, envs, args):
    _entry(rank, fn, world, port, out, envs[rank], args)


# ------------------------------------------------------------ rank bodies

def init_from_environment(rank):
    """maybe_initialize_distributed from torchrun's variables, then an
    all-reduce of the ranks."""
    from multimodal_segmentation_torch.parallel import local_device, maybe_initialize_distributed

    ok = maybe_initialize_distributed()
    x = torch.tensor([float(rank)])
    dist.all_reduce(x)
    again = maybe_initialize_distributed()
    return {"initialised": ok, "again": again, "sum": x.item(),
            "backend": dist.get_backend(), "world": dist.get_world_size(),
            "device": str(local_device())}


class _Scatter(torch.autograd.Function):
    """This rank's shard (dim `dim`, mesh Axis `axis`) of a replicated
    tensor; the backward sums every rank's gradient into the whole."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.shape = dim, axis, x.shape
        k = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * k, k).clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        k = g.shape[ctx.dim]
        full.narrow(ctx.dim, ctx.axis.index * k, k).copy_(g)
        dist.all_reduce(full, group=ctx.axis.group)
        return full, None, None


class _Gather(torch.autograd.Function):
    """The concatenation along `dim` of every rank's tensor, on every rank;
    the backward takes this rank's part of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        from multimodal_segmentation_torch.parallel.collectives import gather

        ctx.dim, ctx.axis, ctx.k = dim, axis, x.shape[dim]
        return gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.k, ctx.k).clone(), None, None


def _gradcheck_cases(axis):
    """gradcheck, in f64, of the differentiable all-reduce and of the halo
    exchange over both transports, as global functions of a replicated
    input: scatter -> op -> gather (so every rank computes the same
    function and perturbs the same entry in step)."""
    from multimodal_segmentation_torch.parallel.collectives import all_reduce_sum, exchange_halos

    n = axis.size
    gen = torch.Generator().manual_seed(5)
    out = {}
    x = torch.randn(2, 3, 2 * n, 4, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.arange(1.0, n + 1.0, dtype=torch.float64)

    def reduced(v):
        s = all_reduce_sum(_Scatter.apply(v, 2, axis), axis.group)
        return _Gather.apply(s * w[axis.index], 2, axis)
    out["all_reduce_sum"] = torch.autograd.gradcheck(reduced, (x,), atol=1e-8)
    for halo in (1, 2):
        xh = torch.randn(1, 2, 2 * n, 3, dtype=torch.float64, generator=gen, requires_grad=True)
        for transport in ("send/recv", "all_reduce"):
            def exchanged(v):
                return _Gather.apply(exchange_halos(_Scatter.apply(v, 2, axis), halo, 2, axis,
                                                    transport), 2, axis)
            out["halo%d %s" % (halo, transport)] = torch.autograd.gradcheck(
                exchanged, (xh,), atol=1e-8)
    return out


def _halo_conv_cases(mesh, cases):
    """halo_conv2d / halo_conv3d of each case's (x, weight) split over
    'space': this rank's output and the weight's and input's gradients of
    sum(out * probe), summed over the ranks."""
    from multimodal_segmentation_torch.parallel import halo_conv2d, halo_conv3d
    from multimodal_segmentation_torch.parallel.collectives import all_reduce_flat_, gather

    space = mesh.axis("space")
    out = {}
    for name, (x, w, probe) in cases.items():
        fn = halo_conv2d if x.ndim == 4 else halo_conv3d
        k = x.shape[1] // space.size
        xs = torch.from_numpy(x[:, space.index * k:(space.index + 1) * k]).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = fn(xs, wt, mesh)
        (y * torch.from_numpy(probe[:, space.index * k:(space.index + 1) * k])).sum().backward()
        gw = wt.grad.clone()
        all_reduce_flat_([gw], space.group)
        out[name] = {"out": gather(y.detach(), 1, space).numpy(), "grad_w": gw.numpy(),
                     "grad_x": gather(xs.grad, 1, space).numpy()}
    return out


def collectives(rank, n, conv_cases, norm_case):
    """On n ranks in one 'space' row (and, n = 2, a 'data' mesh): the
    gradchecks, the halo convs, and (n = 2) grouped BatchNorm and the
    weighted BCE on each rank's half of norm_case."""
    from multimodal_segmentation_torch.parallel import Mesh, shard_batch
    from multimodal_segmentation_torch.parallel.collectives import halo_transport

    mesh = Mesh(("space",), (n,))
    out = {"gradcheck": _gradcheck_cases(mesh.axis("space")),
           "conv": _halo_conv_cases(mesh, conv_cases),
           "halo_transport_cpu": halo_transport(mesh.axis("space"), "cpu")}
    if norm_case is not None:
        data_mesh = Mesh(("data",), (n,))
        out["norm"] = norm_and_bce(data_mesh, **shard_batch(data_mesh, norm_case, "cpu"))
        out["rows"] = shard_batch(data_mesh, {"a": np.arange(8.0).reshape(4, 2)}, "cpu")["a"]
    return out


def norm_and_bce(mesh, x, y_true, y_pred, probe):
    """Grouped BatchNorm (train mode, 2 groups, then one eval call) and
    the weighted BCE (both forms) on a batch, alone (mesh None) or as this
    rank's part under `mesh`. The loss is the global batch's, each rank
    taking its share: sum(BatchNorm output * probe) + bce + sum_b (b + 1)
    bce_perbatch[b] (b the global row), so the ranks' gradients sum to the
    one process's. Returns outputs, gradients (the parameters' summed over
    the ranks) and the running statistics."""
    from multimodal_segmentation_torch import losses
    from multimodal_segmentation_torch.nn.blocks import BatchNorm
    from multimodal_segmentation_torch.parallel.collectives import all_reduce_flat_

    group, ranks, first = None, 1, 0
    if mesh is not None:
        data = mesh.axis("data")
        group, ranks, first = data.group, data.size, data.index * y_true.shape[0]
    torch.manual_seed(0)
    bn = BatchNorm(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    bn.group = group
    xg = x.double().requires_grad_()
    yp = y_pred.double().requires_grad_()
    bn.train()
    out = bn(xg, 2)
    loss = (out * probe.double()).sum()
    bce = losses._reference_weighted_bce(y_true.double(), yp, group=group)
    bce_b = losses._reference_weighted_bce_perbatch(y_true.double(), yp, group=group)
    rows = torch.arange(first + 1.0, first + bce_b.shape[0] + 1, dtype=torch.float64)
    (loss + bce / ranks + (bce_b * rows).sum()).backward()
    grads = {"x": xg.grad, "y_pred": yp.grad}
    param_grads = [bn.weight.grad.clone(), bn.bias.grad.clone()]
    all_reduce_flat_(param_grads, group)
    grads["weight"], grads["bias"] = param_grads
    bn.eval()
    return {"out": out.detach(), "bce": bce.detach(), "bce_perbatch": bce_b.detach(),
            "grads": grads, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "eval_out": bn(x.double()).detach()}


def train_steps(rank, n, conf, state_dict, batches, noises, mesh_size=None, start=None):
    """A 2-D model from `state_dict` and a new train state or, given
    `start`, from that train state (CheckpointManager.state_of of an
    earlier run's), trained on `batches` (global arrays; one step or, for
    MMSDNet, a generator and a discriminator step each), alone (rank None)
    or on a 'data' mesh of n ranks: each batch's metrics, the state_dict
    and the step after them, and `states`: state_of the train state after
    each batch. `noises[i]` is the i-th step's global noise, or None (the
    step draws it). Alone, also `grads`: {parameter name: the gradient of
    every Adam step that updated it, in order}."""
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.parallel import make_mesh, shard_batch
    from multimodal_segmentation_torch.train import create_train_state, make_steps
    from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager

    model = build_model(conf, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    mesh = None if rank is None else make_mesh(n)
    steps = make_steps(model, conf, mesh)
    ts = create_train_state(model, conf)
    if start is not None:
        with tempfile.TemporaryDirectory() as folder:
            manager = CheckpointManager(folder)
            manager.save(0, ts, start)
            manager.restore(0, ts)
    grads = {}
    if rank is None:
        names = {id(p): k for k, p in model.named_parameters()}
        for opt in (ts.opt_gen, ts.opt_zreg, *ts.opt_disc.values()):
            if opt is not None:
                _record_grads(opt, names, grads)
    metrics, states = [], []
    for batch, noise in zip(batches, noises):
        if mesh is not None:
            batch = shard_batch(mesh, batch, "cpu")
        if conf.model == "mmsdnet":
            ts, m = steps.step_supervised(ts, batch["sup"], noise and noise["sup"])
            ts, d = steps.step_discriminator(ts, batch["disc"], noise and noise["disc"])
            m = {**m, **d}
        else:
            ts, m = steps.step_supervised(ts, batch, noise)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(copy.deepcopy(CheckpointManager.state_of(ts)))
    out = {"metrics": metrics, "state": {k: v.clone() for k, v in model.state_dict().items()},
           "states": states, "step": ts.step}
    if rank is None:
        out["grads"] = grads
    return out


def _record_grads(opt, names, grads):
    """Make opt.step append each parameter's gradient to grads[name]
    before it updates."""
    step = opt.step

    def recording(*a, **k):
        for group in opt.param_groups:
            for p in group["params"]:
                grads.setdefault(names[id(p)], []).append(p.grad.detach().clone())
        return step(*a, **k)
    opt.step = recording


def run_executor(rank, n, conf, counting=True):
    """The 2-D executor (train, then test) at `conf` in conf.folder, alone
    (rank None) or on a 'data' mesh of n ranks: the final epoch and step,
    the early stop epoch, the SWA weights, and how many times this rank
    wrote each kind of file."""
    from multimodal_segmentation_torch.eval.tester import ModelTester
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.parallel import make_mesh
    from multimodal_segmentation_torch.train.executor import make_executor
    from multimodal_segmentation_torch.utils import observability
    from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager

    writes = {}

    def counted(cls, name):
        fn = getattr(cls, name)

        def wrapper(*a, **k):
            writes[name] = writes.get(name, 0) + 1
            return fn(*a, **k)
        setattr(cls, name, wrapper)
    for cls, name in ((CheckpointManager, "save"), (CheckpointManager, "save_component_weights"),
                      (observability.LossLogger, "on_epoch_end"),
                      (observability.TrainingImageCallback, "on_epoch_end"),
                      (ModelTester, "run")):
        counted(cls, name)
    model = build_model(conf, device="cpu")
    mesh = None if rank is None else make_mesh(n)
    ex = make_executor(conf, model, device="cpu", mesh=mesh)
    ts = ex.train()
    ex.test()
    return {"epoch": ts.epoch, "step": ts.step, "stopped_epoch": ex.early_stopping.stopped_epoch,
            "swa": {k: v.clone() for k, v in ts.swa.items()}, "writes": writes}


def volumetric_step(rank, shape, conf, state_dict, vb, mb, th, ref_norms, predict_batch):
    """One Cardiac3DSegmenter.step on a ('data', 'space') mesh of `shape`
    (None: alone) from `state_dict`, on the global batch (vb, mb) with the
    global angles th: the loss, every gradient leaf after the mesh's
    reduction, the InstanceNorm3D outputs of this rank's part, and the
    count of ReLU kinks aligned to `ref_norms` (the unsharded run's
    outputs: where a pre-activation's sign differs from the reference's,
    within roundoff of 0, this run takes the reference's value and so its
    ReLU branch, the gradient path kept). Then predict on
    `predict_batch` (any batch size)."""
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DSegmenter
    from multimodal_segmentation_torch.nn.unet3d import InstanceNorm3D
    from multimodal_segmentation_torch.parallel import Mesh

    mesh = None if shape is None else Mesh(("data", "space"), shape)
    model = Cardiac3DSegmenter(conf, device="cpu", mesh=mesh)
    net, opt = model.init(state_dict=state_dict)
    d = s = None
    if mesh is not None:
        d, s = mesh.axis("data"), mesh.axis("space")
    outs, kinks = {}, [0]

    def part(t):
        # this rank's part of a (B, C, D, H, W) tensor of the global batch
        if mesh is None:
            return t
        b, k = t.shape[0] // d.size, t.shape[2] // s.size
        return t[d.index * b:(d.index + 1) * b, :, s.index * k:(s.index + 1) * k]

    def hook(name):
        def f(m, i, o):
            outs[name] = o.detach().clone()
            if ref_norms is None:
                return None
            ref = part(ref_norms[name])
            flip = (o > 0) != (ref > 0)
            kinks[0] += int(flip.sum())
            return o + ((ref - o) * flip).detach()
        return f
    handles = [m.register_forward_hook(hook(n)) for n, m in net.named_modules()
               if isinstance(m, InstanceNorm3D)]
    if mesh is None:
        vbl, mbl = torch.from_numpy(vb), torch.from_numpy(mb)
    else:
        vbl, mbl = model.shard_batch((vb, mb))
    _, _, loss = model.step(net, opt, vbl, mbl, torch.from_numpy(th))
    for h in handles:
        h.remove()
    return {"loss": loss.item(), "grads": {n: p.grad.clone() for n, p in net.named_parameters()},
            "norms": outs, "kinks": kinks[0],
            "predict": model.predict(net, predict_batch).numpy()}


def volumetric_on_meshes(rank, shapes, *args):
    """volumetric_step on each mesh shape in turn (the same ranks)."""
    return {shape: volumetric_step(rank, shape, *args) for shape in shapes}


def run_volumetric_executor(rank, shape, conf):
    """The 3-D executor (train, then test) alone (shape None) or on a
    ('data', 'space') mesh: the test Dice and the training history."""
    from multimodal_segmentation_torch.models.volumetric import Cardiac3DExecutor
    from multimodal_segmentation_torch.parallel import Mesh

    mesh = None if shape is None else Mesh(("data", "space"), shape)
    ex = Cardiac3DExecutor(conf, device="cpu", mesh=mesh)
    ex.train()
    dice = ex.test()
    return {"dice": dice, "params": {k: v.clone() for k, v in ex.params.state_dict().items()}}


# ------------------------------------------------------ tensor parallelism

def tp_state(ts):
    """The whole train state after a run (every sharded leaf gathered:
    a collective on a mesh): the state_dict, the SWA average and each
    optimizer's state_dict."""
    from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager

    state = CheckpointManager.state_of(ts)
    return {k: state[k] for k in ("model", "swa", "opt_gen", "opt_disc", "opt_zreg", "step")}


def tp_run(mesh, conf, state_dict, batches, min_features, ckpt=None, save=None):
    """`conf`'s model from `state_dict` on `mesh` (None: one process), its
    train state sharded at `min_features`, restored from checkpoint folder
    `ckpt` (epoch 0) if given; then `batches`: (kind, batch, noise) steps.
    Then one SWA update, and with `save` a checkpoint of epoch 0 there.
    Returns the metrics, the whole state and, on a mesh, the local shapes
    of the sharded parameters."""
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.parallel import tp_shard_train_state
    from multimodal_segmentation_torch.parallel.sharding import sharded_parameters
    from multimodal_segmentation_torch.train import create_train_state, make_steps
    from multimodal_segmentation_torch.train.swa import swa_update
    from multimodal_segmentation_torch.utils.checkpoint import CheckpointManager

    model = build_model(conf, device="cpu")
    model.load_state_dict(state_dict)
    steps = make_steps(model, conf, mesh)
    ts = create_train_state(model, conf)
    if mesh is not None:
        tp_shard_train_state(mesh, ts, min_features)
    if ckpt is not None:
        CheckpointManager(ckpt).restore(0, ts)
    metrics = []
    for kind, batch, noise in batches:
        if mesh is not None:
            from multimodal_segmentation_torch.parallel import shard_batch

            batch = shard_batch(mesh, batch, "cpu")
        ts, m = getattr(steps, "step_" + kind)(ts, batch, noise)
        metrics.append({k: float(v) for k, v in m.items()})
    swa_update(ts.swa, dict(model.named_parameters()), 1, 0)
    if save is not None:
        mgr = CheckpointManager(save)
        state = mgr.state_of(ts)
        if mesh is None or mesh.rank == 0:
            mgr.save(0, ts, state)
    local = {n: tuple(p.shape) for n, p in sharded_parameters(model).items()}
    moments = {n: tuple(ts.opt_gen.state[p]["exp_avg"].shape)
               for n, p in sharded_parameters(model).items() if p in ts.opt_gen.state}
    return {"metrics": metrics, "state": tp_state(ts), "local_shapes": local,
            "moment_shapes": moments}


def tp_job(rank, shape, jobs, exec_conf=None):
    """On a ('data', 'model') mesh of `shape`: tp_run for each of `jobs`
    ({name: tp_run's arguments after mesh}), then, with `exec_conf`, the
    DAFNet executor (train, then test) at min_features 16."""
    from multimodal_segmentation_torch.parallel import count_sharded_leaves, make_mesh

    mesh = make_mesh(*shape)
    out = {name: tp_run(mesh, *args) for name, args in jobs.items()}
    for name, args in jobs.items():
        out[name]["count"] = count_sharded_leaves(mesh, args[1], args[3])
    if exec_conf is not None:
        out["executor"] = tp_executor(mesh, exec_conf)
    return out


def tp_executor(mesh, conf):
    """The DAFNet executor at `conf` on `mesh` (None: one process), its
    state sharded at min_features 16: train, then test. The SWA average,
    the step count and the parameters' local shapes."""
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.parallel import sharding
    from multimodal_segmentation_torch.parallel.sharding import sharded_parameters, whole_named
    from multimodal_segmentation_torch.train.executor import make_executor

    # the tiny config's widest leaf is far below the executor's 256
    default, sharding.MIN_FEATURES = sharding.MIN_FEATURES, 16
    try:
        model = build_model(conf, device="cpu")
        ex = make_executor(conf, model, device="cpu", mesh=mesh)
        ts = ex.train()
        ex.test()
    finally:
        sharding.MIN_FEATURES = default
    return {"swa": {k: v.clone() for k, v in whole_named(model, ts.swa).items()},
            "step": ts.step, "sharded": sorted(sharded_parameters(model))}


def tp_first_step(rank, conf, state_dict, batch, min_features, device="cuda"):
    """One expert step on the card from `state_dict`, alone (rank None) or
    on a (1, 2) mesh with the state sharded at `min_features`, on PyTorch's
    native convolutions (cuDNN off: the same algorithm in every process):
    its metrics and the number of sharded leaves."""
    from multimodal_segmentation_torch.models import build_model
    from multimodal_segmentation_torch.parallel import make_mesh, tp_shard_train_state
    from multimodal_segmentation_torch.parallel.sharding import sharded_parameters
    from multimodal_segmentation_torch.train import create_train_state, make_steps

    was = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mesh = None if rank is None else make_mesh(1, 2)
        model = build_model(conf, device=device)
        model.load_state_dict(state_dict)
        steps = make_steps(model, conf, mesh)
        ts = create_train_state(model, conf)
        if mesh is not None:
            tp_shard_train_state(mesh, ts, min_features)
        ts, m = steps.step_supervised(ts, batch)
    finally:
        torch.backends.cudnn.enabled = was
    return {"metrics": {k: float(v) for k, v in m.items()},
            "sharded": len(sharded_parameters(model))}
