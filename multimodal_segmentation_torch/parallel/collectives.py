"""Collectives for data and tensor parallelism: a differentiable
all-reduce, the flat in-place reduction of gradients and metrics, the
exchange of the edge slabs of a sharded axis, the gather of a sharded
axis, and the differentiable gather of a weight sharded over 'model'
(`whole_weight`).

No JAX file matches this one: under GSPMD the partitioner inserts these
reductions. `group` is a process group (an Axis's), a tuple of them (a
reduction over each in turn, e.g. over 'data' and 'space'), or None (no
reduction: an axis without torch.distributed). Every rank of a group
calls the same collectives in the same order, forward and backward.
"""

import math

import torch
import torch.distributed as dist


def _groups(group):
    if group is None:
        return ()
    if isinstance(group, (tuple, list)):
        return tuple(g for g in group if g is not None)
    return (group,)


def group_size(group):
    """The ranks a reduction over `group` spans."""
    return math.prod(dist.get_world_size(g) for g in _groups(group))


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the groups' ranks. The loss of rank r reaches
    x of every rank through y, so the gradient of x is the sum of every
    rank's gradient of y: the backward all-reduces it in turn."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        y = x.contiguous().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        return grad, None


def all_reduce_sum(x, group):
    """The sum of `x` over `group`'s ranks, differentiable; `x` itself
    without a group."""
    groups = _groups(group)
    if not groups:
        return x
    return _AllReduceSum.apply(x, groups)


def mean_over(x, group):
    """The mean of `x` over `group`'s ranks, differentiable. Over one rank
    it is `x`, bit for bit (a sum of one, divided by 1)."""
    groups = _groups(group)
    if not groups:
        return x
    return all_reduce_sum(x, groups) / group_size(groups)


@torch.no_grad()
def all_reduce_flat_(tensors, group, divide=1):
    """In place, outside autograd: every tensor := its sum over `group`,
    divided by `divide`, through one flat buffer (one collective a group
    for the whole list). The tensors share a dtype and a device."""
    groups = _groups(group)
    if not groups or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for g in groups:
        dist.all_reduce(flat, group=g)
    if divide != 1:
        flat.div_(divide)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def halo_transport(axis, device):
    """The operation that carries the edge slabs along `axis`:
    'send/recv' (neighbour to neighbour), or 'all_reduce' where the
    backend has no send/recv for the device's tensors (gloo on a card).
    The all-reduce sums a zero-padded buffer of every rank's slabs, which
    carries each slab exactly: every other term of its sum is 0."""
    if dist.get_backend(axis.group) == "gloo" and torch.device(device).type == "cuda":
        return "all_reduce"
    return "send/recv"


def _swap(to_prev, to_next, axis, transport):
    """Send `to_prev` to the previous rank along `axis` and `to_next` to
    the next; returns (from_prev, from_next): what they sent this rank,
    zeros at the ends of the axis (no wrap-around)."""
    i, n = axis.index, axis.size
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    if transport == "all_reduce":
        buf = to_prev.new_zeros((n, 2) + tuple(to_prev.shape))
        buf[i, 0] = to_prev
        buf[i, 1] = to_next
        dist.all_reduce(buf, group=axis.group)
        if i > 0:
            from_prev = buf[i - 1, 1]
        if i < n - 1:
            from_next = buf[i + 1, 0]
        return from_prev, from_next
    if transport != "send/recv":
        raise ValueError("unknown halo transport %r" % (transport,))
    ops = []
    if i > 0:
        peer = axis.ranks[i - 1]
        ops += [dist.P2POp(dist.isend, to_prev.contiguous(), peer, axis.group),
                dist.P2POp(dist.irecv, from_prev, peer, axis.group)]
    if i < n - 1:
        peer = axis.ranks[i + 1]
        ops += [dist.P2POp(dist.isend, to_next.contiguous(), peer, axis.group),
                dist.P2POp(dist.irecv, from_next, peer, axis.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """Extend x by `halo` slabs of its neighbours' along `dim`:
    [prev's last slab, x, next's first slab], zeros at the global ends
    (parallel/halo.py:27-46 of the JAX package). The backward is the
    transpose: each halo's gradient goes back to the rank it came from
    and is added to that rank's edge slab."""

    @staticmethod
    def forward(ctx, x, halo, dim, axis, transport):
        ctx.halo, ctx.dim, ctx.axis, ctx.transport = halo, dim, axis, transport
        n = x.shape[dim]
        top, bottom = _swap(x.narrow(dim, 0, halo).contiguous(),
                            x.narrow(dim, n - halo, halo).contiguous(), axis, transport)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, grad):
        halo, dim = ctx.halo, ctx.dim
        n = grad.shape[dim] - 2 * halo
        g_top, g_bottom = _swap(grad.narrow(dim, 0, halo).contiguous(),
                                grad.narrow(dim, n + halo, halo).contiguous(),
                                ctx.axis, ctx.transport)
        gx = grad.narrow(dim, halo, n).clone()
        gx.narrow(dim, 0, halo).add_(g_top)
        gx.narrow(dim, n - halo, halo).add_(g_bottom)
        return gx, None, None, None, None


def exchange_halos(x, halo, dim, axis, transport=None):
    """`x` extended by `halo` slabs of the neighbours along mesh `axis` on
    both sides of dimension `dim` (zeros at the global ends),
    differentiable. `transport` defaults to halo_transport(axis, x.device)."""
    if halo == 0:
        return x
    if x.shape[dim] < halo:
        raise ValueError("a shard of %d along dim %d is thinner than the halo %d"
                         % (x.shape[dim], dim, halo))
    return _HaloExchange.apply(x, halo, dim, axis,
                               transport or halo_transport(axis, x.device))


@torch.no_grad()
def gather(x, dim, axis):
    """The whole of a tensor split evenly over mesh `axis` along `dim`, on
    every rank of the axis, outside autograd: a zero-padded all-reduce,
    which every backend has for every device and which is exact (each
    entry is its owner's value plus zeros)."""
    if axis.group is None or axis.size == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= axis.size
    buf = x.new_zeros(shape)
    k = x.shape[dim]
    buf.narrow(dim, axis.index * k, k).copy_(x)
    dist.all_reduce(buf, group=axis.group)
    return buf


class _AllGather(torch.autograd.Function):
    """The whole of a tensor split over mesh `axis` along `dim`, on every
    rank of the axis (`gather`). Every rank of the axis computes the same
    function of the whole tensor, so the gradient of the whole is the same
    on each: the backward takes this rank's part of it, with no
    communication."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.index, ctx.k = dim, axis.index, x.shape[dim]
        return gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.k, ctx.k).contiguous(), None, None


def whole_weight(p):
    """The whole weight of parameter `p`, differentiable: `p` itself, or,
    where tensor parallelism holds this rank's slice of its out-channel
    dim (p.model_axis, set by parallel/sharding.py::tp_shard_train_state),
    the slices of every rank of 'model' gathered (a zero-padded
    all-reduce: exact on gloo and NCCL)."""
    axis = getattr(p, "model_axis", None)
    if axis is None:
        return p
    return _AllGather.apply(p, 0, axis)
