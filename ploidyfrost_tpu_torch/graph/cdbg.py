# Copied from ploidyfrost_tpu/graph/cdbg.py; imports point at this package.
"""Compacted de Bruijn graph: import, adjacency, iteration order.

Replaces the CompactedDBG<MyUnitig> role for the analysis phase
(bifrost/src/CompactedDBG.hpp:397-599): holds unitigs, answers
successor/predecessor queries, and assigns unitig ids.

Semantics matched to Bifrost for output parity:

  * iteration order: long unitigs (length > k) in insertion order first,
    then k-length unitigs (bifrost/src/UnitigIterator.tcc:33-58:
    v_unitigs, then km_unitigs, then h_kmers_ccov). GFA import inserts
    in file order, so iteration = file order within each class.
  * neighbor enumeration: for each base in A,C,G,T order, look up the
    k-mer formed by (k-1)-suffix + base; the successor's orientation is
    the one where that k-mer is its first k-mer
    (bifrost/src/NeighborIterator.tcc:24-47, alpha = "ACGT",
    Common.hpp:34).
  * predecessors of (u, s) are the successors of (u, !s) with flipped
    orientation, enumerated in backwardBase A..T order — which equals the
    reverse of the succ(u,!s) enumeration (b prepended == comp(b)
    appended on the twin).

Storage is the 2-bit packed SeqStore (graph/seqstore.py — the
CompressedSequence analog); adjacency is built with VECTORIZED probes
(head/tail k-mers + sorted-table searchsorted, no Python dict walks)
into dense arrays (2 strands x 4 bases per unitig) — the CSR form
consumed by the batched bubble search and the device coverage gathers.
"""

from __future__ import annotations

import numpy as np

from ..kmer.pack import revcomp_np
from .seqstore import SeqStore, SeqView

_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s[::-1].translate(_COMP)


class UnitigHandle:
    """(unitig index, strand) — the UnitigMap analog.

    strand True = reference orientation (UnitigMap.hpp:34-67).
    """

    __slots__ = ("g", "idx", "strand")

    def __init__(self, g: "CDBGraph", idx: int, strand: bool):
        self.g = g
        self.idx = idx
        self.strand = strand

    # equality INCLUDES strand, like UnitigMap::operator== on full maps
    def __eq__(self, o):
        return self.idx == o.idx and self.strand == o.strand

    def __hash__(self):
        return hash((self.idx, self.strand))

    def same_unitig(self, o) -> bool:
        """isSameReferenceUnitig (UnitigMap.hpp:283-288)."""
        return self.idx == o.idx

    @property
    def seq(self) -> str:
        """referenceUnitigToString()."""
        return self.g.seqs[self.idx]

    @property
    def mapped_seq(self) -> str:
        """mappedSequenceToString(): oriented along the handle's strand."""
        s = self.g.seqs[self.idx]
        return s if self.strand else revcomp(s)

    @property
    def size(self) -> int:
        """unitig length in bases (UnitigMap.size)."""
        return int(self.g.store.lengths[self.idx])

    @property
    def length(self) -> int:
        """number of k-mers (UnitigMap.len for a full mapping)."""
        return int(self.g.store.lengths[self.idx]) - self.g.k + 1

    def rev(self) -> "UnitigHandle":
        return UnitigHandle(self.g, self.idx, not self.strand)

    def successors(self) -> list["UnitigHandle"]:
        return self.g.successors(self.idx, self.strand)

    def predecessors(self) -> list["UnitigHandle"]:
        return self.g.predecessors(self.idx, self.strand)

    def __repr__(self):
        return f"UnitigHandle({self.idx}, {'+' if self.strand else '-'})"


class CDBGraph:
    """Unitig set + adjacency. Build from unitig strings / a SeqStore
    (native construction, graph/construct.py) or import a Bifrost GFA."""

    def __init__(self, seqs: list[str] | SeqStore, k: int, g: int | None = None):
        self.k = k
        self.g = g if g is not None else min(k - 2, 23)  # Bifrost default minimizer len
        store = seqs if isinstance(seqs, SeqStore) else SeqStore.from_strings(seqs)
        if len(store) and int(store.lengths.min()) < k:
            bad = int(np.argmin(store.lengths))
            raise ValueError(f"unitig shorter than k: {store.decode(bad)!r}")
        # Bifrost iteration order: long unitigs first, then k-length
        # (UnitigIterator.tcc:33-58); stable within each class
        self._perm = np.argsort(store.lengths <= k, kind="stable")
        if not np.array_equal(self._perm, np.arange(len(store))):
            store = store.reorder(self._perm)
        self.store = store
        self.seqs = SeqView(store)
        self.n = len(store)
        # ids assigned by setUnitigId (1-based, iteration order;
        # src/CDBG.cpp:121-143)
        self.ids = np.arange(1, self.n + 1, dtype=np.int64)
        self._build_adjacency()
        self._kmer_pos_index = None

    def kmer_pos_index(self):
        """Cached canonical-k-mer -> (unitig, position) index
        (graph/colors.KmerPosIndex). The graph is immutable after
        construction, so this is built once per graph — the analog of
        Bifrost's minimizer index, which exists from graph LOAD time
        (bifrost/src/CompactedDBG.tcc:629-652), not per analysis pass."""
        if self._kmer_pos_index is None:
            from .colors import KmerPosIndex

            self._kmer_pos_index = KmerPosIndex(self)
        return self._kmer_pos_index

    # -- adjacency -------------------------------------------------------

    def _build_adjacency(self):
        """Vectorized: entry-kmer table (first k-mer of each orientation,
        first-insertion-wins like Bifrost's hmap) + 8 batched searchsorted
        probes for (k-1)-suffix + base."""
        k = self.k
        n = self.n
        succ = np.full((n, 2, 4), -1, dtype=np.int64)
        if n == 0:
            self._succ = succ
            self._out_deg = (succ >= 0).sum(axis=2)
            return
        head = self.store.head_kmers(k)  # first k bases, MSB-first packed
        tail = self.store.tail_kmers(k)
        tail_rc = revcomp_np(tail, k)
        idx = np.arange(n, dtype=np.int64)
        # entry k-mer -> packed (idx*2 + strand): the k-mer at which a
        # traversal enters the unitig in that orientation. Insertion
        # priority replicates the dict build order (head before tail_rc
        # per unitig, unitigs ascending): first insert wins.
        keys = np.concatenate([head, tail_rc])
        vals = np.concatenate([idx * 2 + 1, idx * 2])
        prio = np.concatenate([idx * 2, idx * 2 + 1])
        order = np.lexsort((prio, keys))
        keys_s = keys[order]
        vals_s = vals[order]
        first = np.ones(len(keys_s), dtype=bool)
        first[1:] = keys_s[1:] != keys_s[:-1]
        ekeys = keys_s[first]
        evals = vals_s[first]

        mask_k1 = np.uint64((1 << (2 * (k - 1))) - 1)
        # (k-1)-suffix of the oriented sequence per strand
        suf_plus = tail & mask_k1  # last k-1 bases of s
        suf_minus = revcomp_np(head >> np.uint64(2), k - 1)  # of revcomp(s)
        top = len(ekeys) - 1
        from ..kmer.countdb import SortedU64Index

        eindex = SortedU64Index(ekeys, 2 * k)
        for strand, suf in ((1, suf_plus), (0, suf_minus)):
            for b in range(4):
                q = (suf << np.uint64(2)) | np.uint64(b)
                pos = np.minimum(eindex.lower_bound(q), top)
                hit = ekeys[pos] == q
                succ[:, strand, b] = np.where(hit, evals[pos], -1)
        self._succ = succ
        self._out_deg = (succ >= 0).sum(axis=2)

    def handle(self, idx: int, strand: bool = True) -> UnitigHandle:
        return UnitigHandle(self, idx, strand)

    def successors(self, idx: int, strand: bool) -> list[UnitigHandle]:
        out = []
        for packed in self._succ[idx, int(strand)]:
            if packed >= 0:
                out.append(UnitigHandle(self, int(packed) // 2, bool(packed & 1)))
        return out

    def out_degree(self, idx: int, strand: bool) -> int:
        return int(self._out_deg[idx, int(strand)])

    def predecessors(self, idx: int, strand: bool) -> list[UnitigHandle]:
        """Predecessors of (idx, strand), in Bifrost's backwardBase A..T
        order == reversed twin-successor order, orientations flipped."""
        rev_succ = self.successors(idx, not strand)
        return [h.rev() for h in reversed(rev_succ)]

    def in_degree(self, idx: int, strand: bool) -> int:
        return int(self._out_deg[idx, int(not strand)])

    # -- iteration & info ---------------------------------------------------

    def __iter__(self):
        for i in range(self.n):
            yield UnitigHandle(self, i, True)

    def __len__(self):
        return self.n

    def nb_kmers(self) -> int:
        return int((self.store.lengths - self.k + 1).sum())

    def total_length(self) -> int:
        return int(self.store.lengths.sum())

    # -- io -----------------------------------------------------------------

    @classmethod
    def from_gfa(cls, path: str) -> "CDBGraph":
        """Import a Bifrost-written GFA (S lines carry full unitig
        sequences; k comes from the KL:Z header tag,
        bifrost/src/CompactedDBG.tcc:7486)."""
        k = None
        g = None
        seqs = []
        da_ids = []
        import gzip

        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as f:
            for line in f:
                if not line:
                    continue
                if line[0] == "H":
                    for tag in line.rstrip("\n").split("\t")[1:]:
                        if tag.startswith("KL:Z:"):
                            k = int(tag[5:])
                        elif tag.startswith("ML:Z:"):
                            g = int(tag[5:])
                elif line[0] == "S":
                    parts = line.rstrip("\n").split("\t")
                    seqs.append(parts[2].upper())
                    da = None
                    for tag in parts[3:]:
                        # DataAccessor tag joining a unitig to its color
                        # set (ColoredCDBG::read, ColoredCDBG.tcc:505-535)
                        if tag.startswith("DA:Z:"):
                            da = int(tag[5:])
                    da_ids.append(da)
        if k is None:
            raise ValueError(f"no KL:Z k-mer-length tag in GFA header of {path}")
        gr = cls(seqs, k, g)
        # re-associate DA tags with the reordered (long-first) seq order
        if any(d is not None for d in da_ids):
            gr.da_ids = [da_ids[p] for p in gr._perm]
        return gr

    def write_gfa(self, path: str, bfg_version: str = "1.0.6", da_ids=None):
        """Bifrost-layout GFA: header with BV/KL/ML tags, S lines with
        sequences (plus DA:Z DataAccessor tags for colored graphs),
        L lines with (k-1)-overlaps (CompactedDBG.tcc:7479+)."""
        k = self.k
        with open(path, "w") as f:
            f.write(
                f"H\tVN:Z:1.0\tBV:Z:{bfg_version}\tKL:Z:{k}\tML:Z:{self.g}\n"
            )
            seqs = self.store.decode_all()
            if da_ids is not None:
                f.write(
                    "".join(
                        f"S\t{i + 1}\t{s}\tLN:i:{len(s)}\tDA:Z:{da_ids[i]}\n"
                        for i, s in enumerate(seqs)
                    )
                )
            else:
                f.write(
                    "".join(
                        f"S\t{i + 1}\t{s}\tLN:i:{len(s)}\n"
                        for i, s in enumerate(seqs)
                    )
                )
            # L lines in (unitig asc, strand + then -, base slot) order,
            # straight off the packed successor array — the per-edge
            # handle-object loop was the slowest part of writing large
            # graphs
            succ = np.asarray(self._succ)[:, ::-1, :].reshape(-1)
            pos = np.flatnonzero(succ >= 0)
            tgt = succ[pos]
            src = (pos // 8 + 1).tolist()
            sstr = np.where(pos % 8 < 4, "+", "-").tolist()
            ov = f"{k - 1}M"
            f.write(
                "".join(
                    f"L\t{a}\t{b}\t{(t >> 1) + 1}\t{'+' if t & 1 else '-'}\t{ov}\n"
                    for a, b, t in zip(src, sstr, tgt.tolist())
                )
            )

    # -- reference-parity outputs -----------------------------------------

    def set_unitig_id(self, outpre: str, outdir: str = "PloidyFrost_output"):
        """setUnitigId (src/CDBG.cpp:121-143): sequential ids 1..N in
        iteration order + {outdir}/{outpre}_Unitig_Id.txt."""
        import os

        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, outpre + "_Unitig_Id.txt"), "w") as f:
            for i, s in enumerate(self.store.decode_all()):
                f.write(f"{i + 1}\t{s}\n")

    def write_graph_info(self, outpre: str):
        """printInfo (src/CDBG.cpp:144-162): {outpre}_graph_info.txt."""
        with open(outpre + "_graph_info.txt", "w") as f:
            f.write(f"k:{self.k}\t")
            f.write(f"g:{self.g}\t")
            f.write(f"nbKmer:{self.nb_kmers()}\t")
            f.write(f"nbUnitig:{self.n}\t")
            f.write(f"length:{self.total_length()}\t")
