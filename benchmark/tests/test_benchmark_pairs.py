"""Pair counting and FOF groups of the reference against brute force on
small periodic boxes."""

import numpy as np
import pytest
import torch

from benchmark.reference import groups, pairs
from benchmark.roofline import fof as roof


def brute(pos, b, box):
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    d2 = (d ** 2).sum(-1)
    return (d2 <= b * b) & ~np.eye(len(pos), dtype=bool)


def components(adj):
    n = len(adj)
    lab = -np.ones(n, int)
    for s in range(n):
        if lab[s] >= 0:
            continue
        stack, lab[s] = [s], s
        while stack:
            i = stack.pop()
            for j in np.nonzero(adj[i])[0]:
                if lab[j] < 0:
                    lab[j] = s
                    stack.append(j)
    return lab


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("windows", [pairs.WINDOWS, 27 * 50])
def test_pairs_within_b_match_brute_force(seed, windows, monkeypatch):
    # the query points in one block, and in blocks of 50
    monkeypatch.setattr(pairs, "WINDOWS", windows)
    rng = np.random.default_rng(seed)
    box, b = 1.0, 0.09
    pos = rng.uniform(0, box, (700, 3))
    pos[:100] = (0.02 + 0.03 * rng.normal(size=(100, 3))) % box  # a clump
    adj = brute(pos, b, box)
    w = roof.count(torch.tensor(pos, dtype=torch.float32), b, box)
    assert w.pairs == adj.sum()
    assert w.n_linked == adj.any(1).sum()
    part = groups.fof(torch.tensor(pos, dtype=torch.float32), b, box)
    want = components(adj)
    got = part.certain.numpy()
    # same partition: a bijection between labels
    assert len(set(zip(got, want))) == len(set(got)) == len(set(want))
    assert torch.equal(part.certain, part.possible) or \
        part.ambiguous_pairs > 0


def test_sandwich_catches_a_split_and_a_merge():
    rng = np.random.default_rng(5)
    pos = np.concatenate([0.2 + 0.01 * rng.normal(size=(50, 3)),
                          0.7 + 0.01 * rng.normal(size=(50, 3)),
                          rng.uniform(0, 1, (20, 3))])
    part = groups.fof(torch.tensor(pos, dtype=torch.float32), 0.03, 1.0)
    right = groups.ids_by_size(part.certain, 20)
    assert groups.sandwich_violations(right, part, 20) == 0
    split = right.clone()
    split[:10] = 3
    assert groups.sandwich_violations(split, part, 5) > 0
    merged = torch.where(right == 2, 1, right)
    assert groups.sandwich_violations(merged, part, 20) == 100
