"""The port's explicit collectives: every byte the multi-device steps move
goes through this module.

The JAX package leaves its collectives to `lax` (`all_gather`, `psum`,
`pmean`) and to GSPMD; here each is a call on a `torch.distributed` process
group, named by an `Axis` (the group, its size and this rank's place in
it):

* `all_gather_rows(x, axis, backward)` concatenates every rank's rows in
  rank order. It is an autograd function whose backward says how the
  gradient of the gathered rows comes back to their owner:
  - "sum": every rank holds a different part of the gradient (the tile
    strategy: each rank's slab adds its own pairs), so the owner needs the
    sum over ranks. A reduce-scatter under NCCL; under gloo an all_reduce
    of the full gradient, then the owner's rows.
  - "slice": the gradient is already the same on every rank (every rank
    computed the same loss from the same gathered rows: the gspmd strategy,
    and the slab assembly of the tile one), so the owner takes its rows
    and nothing moves. Summing there would multiply the gradient by the
    axis size.
* `all_reduce_sum`, `all_reduce_mean`, `all_reduce_max` over one flat
  buffer, without autograd.
* `sum_gradients(x, axis)`: `x` with its gradient summed over the axis,
  for a replicated input (the camera pose under the pose optimizer) that
  each rank uses only on its own rows.
* `gather_state`: the full rows of a list of sharded tensors in one call,
  which every rank of the axis enters.

Transport follows the backend, decided here and never by trying: NCCL
takes the CUDA tensors as they are. Gloo takes CPU tensors; a CUDA tensor
under gloo (several ranks sharing one card, where NCCL refuses) is staged
through host memory explicitly, every op alike, and `staged_bytes` counts
the copies.

`LOG` keeps one record a call: op, dtype, output shape and output bytes
(the accounting of the JAX package's `utils/scaling.py`, which counts the
output bytes of each collective in the compiled program), the axis size,
the backend and the staged bytes. `LOG.clear()` empties it.

An `Axis` with `group=None` and size 1 is the degenerate single process:
each collective returns its input and logs nothing. An `Axis` with
`accounting=True` records what a rank of an `size`-rank world would move
and returns tensors of the right shape without communicating (other ranks'
rows are zeros): `utils/scaling.py` uses it to account a step for a world
it does not have. It is never used on a training path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

LOG: List[dict] = []


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis: `size` ranks, this one at `rank`, talking over
    `group` (None: no process group)."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    accounting: bool = False

    @property
    def active(self) -> bool:
        """Whether a collective on this axis does anything."""
        return self.group is not None or self.accounting

    @property
    def backend(self) -> str:
        if self.accounting:
            return "accounting"
        return str(dist.get_backend(self.group))


def log_totals(records: Optional[Sequence[dict]] = None) -> dict:
    """Calls, output bytes and staged bytes of `records` (default: LOG)."""
    records = LOG if records is None else records
    return {"calls": len(records),
            "bytes": sum(r["bytes"] for r in records),
            "staged_bytes": sum(r["staged_bytes"] for r in records)}


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _staged(axis: Axis, t: torch.Tensor) -> bool:
    """A CUDA tensor under gloo goes through host memory."""
    return not axis.accounting and t.is_cuda and axis.backend == "gloo"


def _record(op: str, t: torch.Tensor, out_shape, axis: Axis,
            staged: int) -> None:
    LOG.append({"op": op, "dtype": str(t.dtype).replace("torch.", ""),
                "shape": ",".join(str(int(d)) for d in out_shape),
                "bytes": _nbytes(out_shape, t.dtype), "axis_size": axis.size,
                "backend": axis.backend, "staged_bytes": staged})


def _all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.contiguous()
    rows = x.shape[0]
    out_shape = (axis.size * rows,) + tuple(x.shape[1:])
    staged = _staged(axis, x)
    _record("all_gather", x, out_shape, axis,
            _nbytes(x.shape, x.dtype) + _nbytes(out_shape, x.dtype)
            if staged else 0)
    if axis.accounting:
        out = x.new_zeros(out_shape)
        out[axis.rank * rows:(axis.rank + 1) * rows] = x
        return out
    if x.is_cuda and not staged:
        out = x.new_empty(out_shape)
        dist.all_gather_into_tensor(out, x, group=axis.group)
        return out
    h = x.cpu() if staged else x
    parts = [torch.empty_like(h) for _ in range(axis.size)]
    dist.all_gather(parts, h, group=axis.group)
    out = torch.cat(parts)
    return out.to(x.device) if staged else out


def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    """A reduced copy of `x` (the input is not changed)."""
    name = {dist.ReduceOp.SUM: "all_reduce_sum",
            dist.ReduceOp.MAX: "all_reduce_max"}[op]
    staged = _staged(axis, x)
    _record(name, x, x.shape, axis,
            2 * _nbytes(x.shape, x.dtype) if staged else 0)
    if axis.accounting:
        return x.clone()
    # a contiguous copy: the backends refuse strided tensors (a gradient
    # may come back as a column view of a wider one)
    y = x.detach().to("cpu" if staged else x.device, copy=True,
                      memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=axis.group)
    return y.to(x.device) if staged else y


def _reduce_scatter_rows(g: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's rows of the sum over ranks of `g` (rows = size x own)."""
    g = g.contiguous()
    rows = g.shape[0] // axis.size
    mine = slice(axis.rank * rows, (axis.rank + 1) * rows)
    if g.is_cuda and not axis.accounting and axis.backend == "nccl":
        out_shape = (rows,) + tuple(g.shape[1:])
        _record("reduce_scatter", g, out_shape, axis, 0)
        out = g.new_empty(out_shape)
        dist.reduce_scatter_tensor(out, g, group=axis.group)
        return out
    if axis.accounting:
        _record("reduce_scatter", g, (rows,) + tuple(g.shape[1:]), axis, 0)
        return g[mine].clone()
    # gloo has no reduce-scatter: all_reduce the full gradient, keep ours
    return _all_reduce(g, axis, dist.ReduceOp.SUM)[mine].contiguous()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, backward):
        ctx.axis, ctx.backward, ctx.rows = axis, backward, x.shape[0]
        return _all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        axis, rows = ctx.axis, ctx.rows
        if ctx.backward == "slice":
            return g[axis.rank * rows:(axis.rank + 1) * rows], None, None
        return _reduce_scatter_rows(g, axis), None, None


def all_gather_rows(x: torch.Tensor, axis: Axis,
                    backward: str = "sum") -> torch.Tensor:
    """(size * rows, ...): every rank's rows of `x` in rank order, each
    rank's rows of equal count. `backward` ("sum" or "slice", see the
    module note) says how the gradient returns to the owner."""
    if backward not in ("sum", "slice"):
        raise ValueError(f"backward {backward!r}: 'sum' or 'slice'")
    if not axis.active:
        return x
    return _GatherRows.apply(x, axis, backward)


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.axis, dist.ReduceOp.SUM), None


def sum_gradients(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """`x` itself, with its gradient summed over the ranks of `axis`: for
    a replicated input (the camera pose) used by each rank's own rows,
    whose gradient every rank holds only its rows' part of."""
    if not axis.active or not x.requires_grad:
        return x
    return _SumGradients.apply(x, axis)


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if not axis.active:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def all_reduce_mean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if not axis.active:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.SUM) / axis.size


def all_reduce_max(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if not axis.active:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat float32 buffer of `tensors`, for a single collective."""
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def unflatten(buf: torch.Tensor, like: Sequence[torch.Tensor]
              ) -> List[torch.Tensor]:
    """The inverse of `flatten`, shaped (and typed) as `like`."""
    out, o = [], 0
    for t in like:
        n = t.numel()
        out.append(buf[o:o + n].reshape(t.shape).to(t.dtype))
        o += n
    return out


@torch.no_grad()
def gather_state(tensors: Sequence[torch.Tensor], axis: Axis
                 ) -> List[torch.Tensor]:
    """The full rows of each of `tensors` (float32 shards along dim 0), in
    one gather. Every rank of `axis` must enter it."""
    if not axis.active:
        return list(tensors)
    flat = flatten(tensors)
    full = _all_gather(flat, axis).reshape(axis.size, flat.numel())
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        out.append(full[:, o:o + n].reshape(
            (axis.size * t.shape[0],) + tuple(t.shape[1:])).to(t.dtype))
        o += n
    return out
