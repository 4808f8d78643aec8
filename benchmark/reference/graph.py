"""Plain reference of the compacted de Bruijn graph.

From a set of canonical k-mers (k odd, so no k-mer is its own reverse
complement): every oriented k-mer's successors in the set, the unitigs
as maximal non-branching paths (two k-mers join when the first has one
successor, the second one predecessor, and they differ), then the
upstream's one pass of simplification (Bifrost `-i -d`): a unitig of
fewer than 2k bases with no successor at one of its ends is deleted,
and the k-mers left are compacted again.

A unitig is named by its k-mers: `labels[i]` is the unitig of the i-th
key of the sorted set. Plain torch on the given device for the lookups,
scipy for the connected components.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch

from .kmers import canonical, revcomp


def successors(keys: torch.Tensor, k: int) -> torch.Tensor:
    """[n, 2, 4] int64: for key i read forward (0) or as its reverse
    complement (1), and each next base b, the successor's index * 2 +
    its orientation (1 when the successor is the reverse complement of
    its key), or -1 when the successor is not in the set."""
    n = keys.numel()
    mask = (1 << (2 * k)) - 1
    out = torch.full((n, 2, 4), -1, dtype=torch.int64, device=keys.device)
    if n == 0:
        return out
    for o, v in enumerate((keys, revcomp(keys, k))):
        for b in range(4):
            t = ((v << 2) | b) & mask
            c = canonical(t, k)
            idx = torch.searchsorted(keys, c).clamp_(max=n - 1)
            hit = keys[idx] == c
            out[:, o, b] = torch.where(hit, idx * 2 + (t != c).to(torch.int64), -1)
    return out


def unitig_labels(keys: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(labels [n], dead-end flag [n]) of the keys' unitigs. A k-mer's
    dead-end flag is set when one of its sides has no join and no
    successor: the unitig's end there."""
    n = keys.numel()
    succ = successors(keys, k)
    deg = (succ >= 0).sum(2)  # [n, 2]: successors of the forward and the rc reading
    first = succ.max(2).values  # the one successor where deg == 1
    j = first >> 1
    p = first & 1
    src = torch.arange(n, device=keys.device)
    joins = []
    ends = torch.zeros(n, dtype=torch.bool, device=keys.device)
    for o in (0, 1):
        one = deg[:, o] == 1
        jj = torch.where(one, j[:, o], 0)
        # the successor's predecessors = the successors of its other reading
        back = deg[jj, 1 - p[:, o].clamp(min=0)]
        join = one & (back == 1) & (jj != src)
        joins.append(torch.stack([src[join], jj[join]]))
        ends |= ~join & (deg[:, o] == 0)
    e = torch.cat(joins, 1).cpu().numpy()
    adj = scipy.sparse.coo_matrix((np.ones(e.shape[1], dtype=np.int8), (e[0], e[1])), shape=(n, n))
    _, labels = scipy.sparse.csgraph.connected_components(adj, directed=False)
    return labels.astype(np.int64), ends.cpu().numpy()


def compacted(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, np.ndarray]:
    """The simplified graph: (its sorted keys, their unitig labels)."""
    labels, ends = unitig_labels(keys, k)
    size = np.bincount(labels)
    dead = np.zeros(len(size), dtype=bool)
    np.logical_or.at(dead, labels, ends)
    drop = (size + k - 1 < 2 * k) & dead
    if drop.any():
        keep = torch.from_numpy(~drop[labels]).to(keys.device)
        keys = keys[keep]
        labels, _ = unitig_labels(keys, k)
    return keys, labels


def sequence_keys(seqs: list[str], k: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """(canonical keys of every k-window of every sequence, in order;
    the index of the sequence each comes from). Sequences of ACGT."""
    if not seqs:
        return torch.zeros(0, dtype=torch.int64, device=device), np.zeros(0, dtype=np.int64)
    lut = np.full(256, 255, dtype=np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=len(seqs))
    codes = lut[np.frombuffer("".join(seqs).encode(), dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError("a sequence holds a letter other than ACGT")
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nwin = np.maximum(lens - k + 1, 0)
    owner = np.repeat(np.arange(len(seqs)), nwin)
    pos = np.arange(int(nwin.sum())) - np.repeat(np.cumsum(nwin) - nwin, nwin) + np.repeat(starts, nwin)
    x = torch.from_numpy(codes).to(device).to(torch.int64)
    p = torch.from_numpy(pos).to(device)
    fwd = torch.zeros(len(pos), dtype=torch.int64, device=device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        c = x[p + j]
        fwd = (fwd << 2) | c
        rev = rev | ((3 - c) << (2 * j))
    return torch.minimum(fwd, rev), owner


def lookup(keys: torch.Tensor, q: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(index into keys, found) of each query."""
    n = keys.numel()
    if n == 0:
        return np.zeros(q.numel(), dtype=np.int64), np.zeros(q.numel(), dtype=bool)
    idx = torch.searchsorted(keys, q).clamp_(max=n - 1)
    return idx.cpu().numpy(), (keys[idx] == q).cpu().numpy()


def unitigs_off(keys: torch.Tensor, labels: np.ndarray, seqs: list[str], k: int) -> dict:
    """How far the program's unitig sequences are from the reference's
    unitigs: the program's unitigs that are not exactly one reference
    unitig (every k-mer in it, none twice, none missing), plus the
    reference's unitigs that no program unitig is."""
    q, owner = sequence_keys(seqs, k, keys.device)
    idx, found = lookup(keys, q)
    n_ref = int(labels.max()) + 1 if len(labels) else 0
    n_prog = len(seqs)
    lab = np.where(found, labels[idx] if len(labels) else 0, -1)
    size_ref = np.bincount(labels, minlength=n_ref)
    size_prog = np.bincount(owner, minlength=n_prog)
    lo = np.full(n_prog, np.iinfo(np.int64).max)
    hi = np.full(n_prog, -2, dtype=np.int64)
    np.minimum.at(lo, owner, lab)
    np.maximum.at(hi, owner, lab)
    one = (lo == hi) & (lo >= 0)
    match = one & (size_prog == size_ref[np.where(one, lo, 0)])
    # a k-mer in two program unitigs would let two of them match one
    dup = len(np.unique(idx[found])) != int(found.sum())
    matched_ref = np.zeros(n_ref, dtype=bool)
    matched_ref[lo[match]] = True
    return {"prog_unitigs": n_prog, "ref_unitigs": n_ref,
            "off": int((~match).sum() + (~matched_ref).sum() + (1 if dup else 0))}
