"""The reference's superbubble search (benchmark/reference/bubbles.py)
lists what the port's search lists, on graphs made straight from a
genome's haplotypes: with a palindrome that sends one walk to the
genome's end, and on three samples with the colored gates."""

import numpy as np

from benchmark.gen import reads
from benchmark.reference import bubbles

K = 25


def haplotype_kmers(haps: list[np.ndarray]) -> list[np.ndarray]:
    return [np.unique(reads._windows(h, K)[0]) for h in haps]


def port_graph(kmers: np.ndarray):
    from ploidyfrost_tpu_torch.graph.construct import build_graph_from_kmers, simplify

    return simplify(build_graph_from_kmers(kmers.astype(np.uint64), K), K)


def port_listing(g, colors=None) -> list[tuple[int, tuple]]:
    from ploidyfrost_tpu_torch.bubble.batched import find_superbubbles_device

    _, found = find_superbubbles_device(g, 8, colors, device="cpu")
    return [(b.bubble_id, (int(g.ids[b.entrance]), "+" if b.strand else "-",
                           int(g.ids[b.exit]), int(b.strict), int(b.complex))) for b in found]


def genome(seed: int, n: int, palindrome: bool) -> np.ndarray:
    g = reads._rng(seed, 0).integers(0, 4, n, dtype=np.uint8)
    g = reads._unique_windows(g, [], K - 1)
    if palindrome:  # 26 bases equal to their own reverse complement
        half = reads._rng(seed, 9).integers(0, 4, 13, dtype=np.uint8)
        g[n // 3:n // 3 + 26] = np.concatenate([half, 3 - half[::-1]])
    return g


def diploid(g: np.ndarray, seed: int, het: float) -> list[np.ndarray]:
    rng = reads._rng(seed, 1)
    snp = np.flatnonzero(rng.random(len(g)) < het)
    return [g, reads._apply(g, (snp, rng.integers(1, 4, len(snp), dtype=np.uint8)))]


def test_one_sample_listing_equals_the_port():
    """Also where a palindrome lets one walk run to the genome's end and
    drop the bubbles it passed, as the upstream's search does."""
    listed = []
    for palindrome in (False, True):
        g = genome(21, 60_000, palindrome)
        graph = port_graph(np.unique(np.concatenate(haplotype_kmers(diploid(g, 21, 0.01)))))
        program = port_listing(graph)
        search = bubbles.Search(bubbles.adjacency(graph.store.decode_all(), K))
        search.run()
        assert bubbles.listing_off(program, search.listing()) == 0
        listed.append(len(program))
    assert listed[0] > 600 and listed[1] < 0.8 * listed[0]


def test_colored_listing_equals_the_port():
    from ploidyfrost_tpu_torch.graph.colors import ColorMatrix

    g = genome(22, 60_000, False)
    samples = [haplotype_kmers(diploid(g, 30 + s, 0.003)) for s in range(3)]
    sets = [np.unique(np.concatenate(h)) for h in samples]
    graph = port_graph(np.unique(np.concatenate(sets)))
    flat, lens = graph.store.all_kmers(K)  # as written: made canonical here
    flat = flat.astype(np.int64)
    canon = np.minimum(flat, bubbles._rc(flat, K))
    bits = np.stack([np.isin(canon, s) for s in sets], 1)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    program = port_listing(graph, ColorMatrix(offsets, bits, ["a", "b", "c"]))
    starts = offsets[:-1]
    carried = np.add.reduceat(bits.astype(np.int64), starts, axis=0)
    full = carried == lens[:, None]
    search = bubbles.Search(bubbles.adjacency(graph.store.decode_all(), K),
                            colors=(full.tolist(), carried.sum(1).tolist(), lens.tolist()))
    search.run()
    assert len(program) > 100
    assert bubbles.listing_off(program, search.listing()) == 0


def test_listing_off_counts_rows_and_numbering():
    ref = [(1, "+", 2, 1, 0), (3, "-", 4, 0, 0)]
    assert bubbles.listing_off(list(enumerate(ref, 1)), ref) == 0
    assert bubbles.listing_off([(1, ref[0])], ref) == 1
    assert bubbles.listing_off([(2, ref[0]), (1, ref[1])], ref) == 2
    assert bubbles.listing_off(list(enumerate(ref + [(5, "+", 6, 0, 1)], 1)), ref) == 1
