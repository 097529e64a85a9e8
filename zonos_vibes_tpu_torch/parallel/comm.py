"""The collectives of the parallel layer, over one ``torch.distributed`` group.

GSPMD inserted these in the JAX package: the all-reduce after a
row-parallel projection, the gathers of vocab-sharded logits and of
data-sharded rows, ``ppermute`` for the pipeline's hand-off and the ring,
``all_to_all`` for Ulysses and the expert dispatch. Here each is one call on
a :class:`Comm`, the group of one mesh axis as one rank sees it.

The backend is the caller's choice, made once for the process group: NCCL
when each rank owns a card, gloo for the CPU and for several ranks sharing
one card (NCCL refuses two ranks on one device). Nothing switches between
them. On the card's torch (2.11, ``tools/probe_dist_cuda.py``) gloo takes
CUDA tensors for all-reduce, broadcast, all-gather and all-to-all, and
aborts the process on a CUDA send or receive; so under gloo a
point-to-point transfer of a CUDA tensor goes through an explicit host
buffer, and every other collective takes the tensor as it is (an explicit
host copy made the all-reduce no faster on the card). The backend of each
group is read from the group. That is the transport only: the kernels run
on the card either way.

Every call is issued on every rank of the group, also for a group of one
rank, so one program serves one card or many and a captured decode step
holds its collectives (NCCL: captured into the step's CUDA graph, seen on
the card for a one-rank all-gather only, several ranks not yet run; gloo:
the engine refuses graphs).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Comm:
    """One mesh axis's group as rank ``rank`` of ``size`` sees it; point-to-point
    calls name peers by their rank in this group."""

    def __init__(self, group):
        self.group = group
        self.backend = dist.get_backend(group)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _global(self, peer: int) -> int:
        return dist.get_global_rank(self.group, peer)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a point-to-point transfer takes it: a host copy under gloo
        for a CUDA tensor, else ``t``."""
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or ``op="max"``) over the group, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        dist.broadcast(t, src=self._global(src), group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """JAX's tiled ``all_to_all``: ``t`` cut into ``size`` equal pieces
        along ``split_dim``, piece ``j`` sent to rank ``j``, and the pieces
        received concatenated along ``concat_dim`` in rank order."""
        pieces = torch.stack(t.chunk(self.size, dim=split_dim)).contiguous()
        out = torch.empty_like(pieces)
        dist.all_to_all_single(out, pieces, group=self.group)
        return torch.cat(out.unbind(0), dim=concat_dim)

    def shift_(self, t: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The ring's ``ppermute``: ``t`` to rank ``rank + 1`` and, into
        ``out`` (contiguous), rank ``rank - 1``'s ``t`` (modulo ``size``);
        both transfers in flight together, so no rank waits on its own send."""
        if self.size == 1:
            return out.copy_(t)
        src = self._host(t.contiguous())
        dst = self._host(out)
        reqs = [dist.isend(src, dst=self._global((self.rank + 1) % self.size), group=self.group),
                dist.irecv(dst, src=self._global((self.rank - 1) % self.size), group=self.group)]
        for r in reqs:
            r.wait()
        if dst is not out:
            out.copy_(dst)
        return out

    def send(self, t: torch.Tensor, dst: int) -> None:
        dist.send(self._host(t.contiguous()), dst=self._global(dst), group=self.group)

    def recv_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Fill ``t`` (contiguous) with rank ``src``'s :meth:`send`."""
        buf = self._host(t)
        dist.recv(buf, src=self._global(src), group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t
