"""Friends-of-friends groups, plain torch in float64.

A link is a pair whose criterion q (distance squared over the linking
length squared, plus the velocity term in 6D) is at most 1.  Float32
rounding in the program can move q by a few parts in 10^7, so the
reference forms two partitions: ``certain`` from links with
q <= 1 - DELTA and ``possible`` from links with q <= 1 + DELTA.  The
program's groups have to lie between them.  Where no pair falls in the
margin, the two are one partition.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .pairs import dist2, neighbour_pairs

DELTA = 1e-5


def _compress(labels: torch.Tensor) -> torch.Tensor:
    while True:
        nxt = labels[labels]
        if torch.equal(nxt, labels):
            return labels
        labels = nxt


def union(labels: torch.Tensor, i: torch.Tensor, j: torch.Tensor
          ) -> torch.Tensor:
    """Join the components of every (i, j) edge: each root hooks to the
    smaller root, then labels are compressed, until the edges agree.
    ``labels`` are roots (labels[labels] == labels) before and after."""
    while i.numel():
        li, lj = labels[i], labels[j]
        diff = li != lj
        if not bool(diff.any()):
            break
        i, j, li, lj = i[diff], j[diff], li[diff], lj[diff]
        lo, hi = torch.minimum(li, lj), torch.maximum(li, lj)
        labels = labels.scatter_reduce(0, hi, lo, "amin")
        labels = _compress(labels)
    return labels


@dataclass
class Partition:
    certain: torch.Tensor       # (n,) component root per point
    possible: torch.Tensor
    ambiguous_pairs: int


def fof(pos: torch.Tensor, b: float, box: float,
        extra: Optional[Callable] = None,
        budget: Optional[int] = None) -> Partition:
    """FOF of ``pos`` with linking length ``b`` in a periodic box;
    ``extra(i, j)`` adds a term to q (the 6D velocity term) and returns
    (term, allowed) with ``allowed`` False where the pair may not link,
    or (term, allowed, slack): q's rounding margin widened by ``slack``
    on both sides (a term whose own scale carries a rounding margin)."""
    n = pos.shape[0]
    dev = pos.device
    cert = torch.arange(n, device=dev)
    amb_i, amb_j = [], []
    b2 = float(b) * float(b)
    for qi, rj in neighbour_pairs(pos, pos, b * (1 + DELTA), box, budget):
        keep = qi < rj
        qi, rj = qi[keep], rj[keep]
        q = dist2(pos[qi], pos[rj], box) / b2
        slack = 0.0
        if extra is not None:
            near = q <= 1 + DELTA
            qi, rj, q = qi[near], rj[near], q[near]
            term, allowed, *widen = extra(qi, rj)
            q = torch.where(allowed, q + term, torch.inf)
            if widen:
                slack = widen[0]
        sure = q + slack <= 1 - DELTA
        cert = union(cert, qi[sure], rj[sure])
        maybe = ~sure & (q - slack <= 1 + DELTA)
        if bool(maybe.any()):
            amb_i.append(qi[maybe])
            amb_j.append(rj[maybe])
    poss = cert.clone()
    namb = 0
    if amb_i:
        ai, aj = torch.cat(amb_i), torch.cat(amb_j)
        namb = int(ai.numel())
        poss = union(poss, ai, aj)
    return Partition(certain=cert, possible=poss, ambiguous_pairs=namb)


def sizes_of(labels: torch.Tensor) -> torch.Tensor:
    """(n,) size of each point's component."""
    return torch.bincount(labels, minlength=labels.shape[0])[labels]


def ids_by_size(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Group ids 1.. by decreasing size (ties by smallest root) for
    components of ``min_size`` or more, 0 elsewhere."""
    n = labels.shape[0]
    cnt = torch.bincount(labels, minlength=n)
    roots = torch.nonzero(cnt >= min_size).squeeze(1)
    order = torch.argsort(-cnt[roots] * (n + 1) + roots)
    gid = torch.zeros(n, dtype=torch.int64, device=labels.device)
    gid[roots[order]] = torch.arange(1, roots.numel() + 1,
                                     device=labels.device)
    return gid[labels]


def sandwich_violations(prog: torch.Tensor, part: Partition,
                        min_size: int) -> int:
    """Points at which the program's group ids ``prog`` (0 = none) break
    FOF: a program group not inside one possible component, a certain
    component split or partly grouped, a program group under
    ``min_size``, or an ungrouped point whose certain component reaches
    ``min_size``."""
    n = prog.shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=prog.device)
    grouped = prog > 0
    big = prog.max().item() + 1 if n else 1
    # each program group inside one possible component
    lo = torch.full((big,), n, dtype=torch.int64, device=prog.device)
    hi = torch.full((big,), -1, dtype=torch.int64, device=prog.device)
    lo = lo.scatter_reduce(0, prog, part.possible, "amin")
    hi = hi.scatter_reduce(0, prog, part.possible, "amax")
    bad |= grouped & (lo[prog] != hi[prog])
    # each certain component wholly in one program group, or in none
    lo = torch.full((n,), big, dtype=torch.int64, device=prog.device)
    hi = torch.full((n,), -1, dtype=torch.int64, device=prog.device)
    lo = lo.scatter_reduce(0, part.certain, prog, "amin")
    hi = hi.scatter_reduce(0, part.certain, prog, "amax")
    bad |= lo[part.certain] != hi[part.certain]
    # sizes
    psize = torch.bincount(prog, minlength=big)
    bad |= grouped & (psize[prog] < min_size)
    bad |= ~grouped & (sizes_of(part.certain) >= min_size)
    return int(bad.sum())


def subset_violations(prog: torch.Tensor, labels: torch.Tensor,
                      allowed: torch.Tensor) -> int:
    """Points of program groups (``prog`` > 0) that are not all in one
    component of ``labels`` with ``allowed`` True there."""
    n = prog.shape[0]
    grouped = prog > 0
    big = int(prog.max()) + 1 if n else 1
    lab = torch.where(allowed, labels, -1 - torch.arange(
        n, device=prog.device))
    lo = torch.full((big,), n, dtype=torch.int64, device=prog.device)
    hi = torch.full((big,), -n - 2, dtype=torch.int64, device=prog.device)
    lo = lo.scatter_reduce(0, prog, lab, "amin")
    hi = hi.scatter_reduce(0, prog, lab, "amax")
    bad = grouped & ((lo[prog] != hi[prog]) | ~allowed)
    return int(bad.sum())
