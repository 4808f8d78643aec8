"""The comparison that decides `correct` catches the faults the cells
can have: the run below skips the harness's look for a card and drives
the rest of a run on the CPU with the timed path broken underneath."""

import os
import time

import numpy as np
import pytest
import torch

from benchmark import run, spec
from benchmark.tests.conftest import tiny

BENCH = spec.benchmark()
SITE_NUMBERS = ("align_off", "strict_rows_off", "multi_rows_off", "branching_rows_off")
# a small tetraploid of the generator's shared-site and indel recipe
TETRAPLOID = {"name": "tetraploid.full", "config": "tetraploid", "traffic": "full", "chips": 1}


def tetraploid(genome_bp: int = 100_000) -> dict:
    return dict(spec.config("snj17", BENCH), name="tetraploid", genome_bp=genome_bp, ploidy=4,
                samples=[{"name": "tetraploid", "monoploid_coverage": 18.0, "het": 0.0}],
                shared_site_rate=0.006, shared_site_carry=0.6, indel_rate=0.0003,
                indel_max_len=6, indel_runs_per_mbp=8)


def drive(tmp_path, cell_name="snj17.full", seed=2**31 + 11, fault=None, whole=False):
    if cell_name == TETRAPLOID["name"]:
        cell, cfg = TETRAPLOID, tetraploid()
    else:
        cell = spec.cell(cell_name, BENCH)
        cfg = tiny(spec.config(cell["config"], BENCH), 40_000)
    here = os.getcwd()
    try:
        r = run.run_cell(cell, cfg, spec.traffic(cell["traffic"]), seed, 0.0, False, "cpu",
                         time.time(), spec.limits(), BENCH, str(tmp_path), processes=1,
                         after_setup=fault)
    finally:
        os.chdir(here)
    return r if whole else r["result"]


def state_unchanged(monkeypatch):
    """The counter's step returns its state unchanged."""
    from ploidyfrost_tpu_torch.kmer import count

    monkeypatch.setattr(count.KmerCounter, "add_reads", lambda self, codes: None)


def half_batch(monkeypatch):
    """Half of every read batch left out."""
    from ploidyfrost_tpu_torch.kmer import count

    add = count.KmerCounter.add_reads

    def half(self, codes):
        codes = torch.as_tensor(codes)
        return add(self, codes[: codes.shape[0] // 2])

    monkeypatch.setattr(count.KmerCounter, "add_reads", half)


def count_altered(monkeypatch):
    """One count of the table altered where it is produced."""
    from ploidyfrost_tpu_torch.kmer import count

    arrays = count.KmerCounter.arrays

    def altered(self):
        km, ct = arrays(self)
        ct = np.array(ct, copy=True)
        ct[len(ct) // 2] += 1
        return km, ct

    monkeypatch.setattr(count.KmerCounter, "arrays", altered)


def fit_altered(monkeypatch):
    """The GMM's answer altered where it is produced: one weight a fit
    off by one part in a million."""
    from ploidyfrost_tpu_torch.model import gmm

    iterate = gmm.GmmModel.em_iterate

    def altered(self):
        iterate(self)
        self.weights = self.weights * (1 + 1e-6)

    monkeypatch.setattr(gmm.GmmModel, "em_iterate", altered)


def unitig_dropped(monkeypatch):
    """The graph build loses a unitig."""
    from ploidyfrost_tpu_torch.graph import cdbg

    write = cdbg.CDBGraph.write_gfa

    def dropped(self, path, *a, **kw):
        write(self, path, *a, **kw)
        with open(path) as f:
            lines = f.readlines()
        s = [i for i, line in enumerate(lines) if line.startswith("S\t")]
        del lines[s[len(s) // 2]]
        with open(path, "w") as f:
            f.writelines(lines)

    monkeypatch.setattr(cdbg.CDBGraph, "write_gfa", dropped)


def site_row_altered(monkeypatch):
    """The sites pass writes one strict row's coverage altered (the
    pipeline imports write_outputs from its module at each call)."""
    from ploidyfrost_tpu_torch.sites import emit

    write = emit.write_outputs

    def altered(emissions, wcov, outpre, outdir="PloidyFrost_output"):
        stats = write(emissions, wcov, outpre, outdir)
        path = os.path.join(outdir, outpre + "_bicov.txt")
        with open(path) as f:
            rows = f.readlines()
        i = next(i for i, r in enumerate(rows) if r.split("\t")[2] == "1")
        cells = rows[i].split("\t")
        cells[0] = repr(float(cells[0]) + 1.0)
        rows[i] = "\t".join(cells)
        with open(path, "w") as f:
            f.writelines(rows)
        return stats

    monkeypatch.setattr(emit, "write_outputs", altered)


def _after_tables(monkeypatch, change):
    """The sites pass writes its tables, then `change(outdir, outpre)`
    alters them."""
    from ploidyfrost_tpu_torch.sites import emit

    write = emit.write_outputs

    def altered(emissions, wcov, outpre, outdir="PloidyFrost_output"):
        stats = write(emissions, wcov, outpre, outdir)
        change(outdir, outpre)
        return stats

    monkeypatch.setattr(emit, "write_outputs", altered)


def _table(outdir, outpre, name):
    with open(os.path.join(outdir, outpre + name)) as f:
        return f.readlines()


def _write(outdir, outpre, name, lines):
    with open(os.path.join(outdir, outpre + name), "w") as f:
        f.writelines(lines)


def tri_row_altered(monkeypatch):
    """One row of the three-allele table with a coverage altered."""
    def change(outdir, outpre):
        rows = _table(outdir, outpre, "_tricov.txt")
        cells = rows[0].split("\t")
        cells[1] = repr(float(cells[1]) + 1.0)
        rows[0] = "\t".join(cells)
        _write(outdir, outpre, "_tricov.txt", rows)

    _after_tables(monkeypatch, change)


def tetra_row_dropped(monkeypatch):
    """The four-allele table's first row and its frequencies left out."""
    def change(outdir, outpre):
        _write(outdir, outpre, "_tetracov.txt", _table(outdir, outpre, "_tetracov.txt")[1:])
        _write(outdir, outpre, "_tetrafre.txt", _table(outdir, outpre, "_tetrafre.txt")[4:])

    _after_tables(monkeypatch, change)


def branching_frequency_altered(monkeypatch):
    """A non-strict bubble's two-allele row with its first frequency altered."""
    def change(outdir, outpre):
        rows = _table(outdir, outpre, "_bicov.txt")
        i = next(i for i, r in enumerate(rows) if r.split("\t")[2] == "0")
        fre = _table(outdir, outpre, "_bifre.txt")
        fre[2 * i] = repr(float(fre[2 * i]) + 0.01) + "\n"
        _write(outdir, outpre, "_bifre.txt", fre)

    _after_tables(monkeypatch, change)


def gap_moved(monkeypatch):
    """A gap of an aligned branch moved one column on, to a place the
    upstream's scoring does not reach (a base of the row against the
    other rows' gap): the branch itself is unchanged."""
    def change(outdir, outpre):
        lines = _table(outdir, outpre, "_alignseq.txt")
        for i, line in enumerate(lines):
            row = line.rstrip("\n").split("\t")[4]
            g = row.find("-")
            if g > 0 and row[g - 1] != "-" and "-" not in row[g + 1:g + 3]:
                row = row[:g - 1] + "-" + row[g - 1] + row[g + 1:]
                lines[i] = "\t".join(line.split("\t")[:4] + [row]) + "\n"
                break
        _write(outdir, outpre, "_alignseq.txt", lines)

    _after_tables(monkeypatch, change)


def three_branch_block_removed(monkeypatch):
    """The block of a strict bubble of three gapless branches left out of
    `_alignseq.txt` (its rows stay in the tables)."""
    def change(outdir, outpre):
        lines = _table(outdir, outpre, "_alignseq.txt")
        cells = [line.rstrip("\n").split("\t") for line in lines]
        rows: dict[str, list[str]] = {}
        for c in cells:
            if c[1] == "1":
                rows.setdefault(c[0], []).append(c[4])
        var = next(v for v, r in rows.items() if len(r) == 3 and "-" not in "".join(r))
        _write(outdir, outpre, "_alignseq.txt", [l for l, c in zip(lines, cells) if c[0] != var])

    _after_tables(monkeypatch, change)


def gapped_bubbles_dropped(monkeypatch):
    """The sites pass keeps no alignment of a bubble whose branches need
    gaps, as where the traceback's cap on runs of gaps leaves nothing:
    their blocks and rows are left out and the VarIds close up."""
    from ploidyfrost_tpu_torch.align import msa

    align = msa.SeqAlign.sequence_alignment

    def dropped(self, strs, first_align=None):
        out = align(self, strs, first_align=first_align)
        return ([], [], [], [], []) if any("-" in row for row in out[0]) else out

    monkeypatch.setattr(msa.SeqAlign, "sequence_alignment", dropped)


def seeds_halved(monkeypatch):
    """The superbubble search drops every other seed it was given."""
    from ploidyfrost_tpu_torch.bubble import batched

    seeds = batched.canonical_seeds
    monkeypatch.setattr(batched, "canonical_seeds", lambda g: seeds(g)[::2])


def test_sound_run_is_correct(tmp_path):
    r = drive(tmp_path, whole=True)
    res, counts = r["result"], r["info"]["check_counts"]
    assert res["correct"], res["checks"]
    assert all(res["checks"][n]["value"] == 0 for n in SITE_NUMBERS)
    assert counts["_rows_checked"] == counts["_rows"] > 0


def test_sound_tetraploid_is_correct(tmp_path):
    """The generator's shared sites and indels through the port's
    pipeline: every number 0, ploidy 4, and rows of every kind checked."""
    r = drive(tmp_path, TETRAPLOID["name"], whole=True)
    res, counts = r["result"], r["info"]["check_counts"]
    assert res["correct"], res["checks"]
    assert all(res["checks"][n]["value"] == 0 for n in SITE_NUMBERS)
    with open(os.path.join(tmp_path, "call.log")) as f:
        assert "estimated ploidy level is : 4" in f.read()
    assert counts["_rows_checked"] == counts["_rows"]
    assert min(counts["_strict_rows"], counts["_multi_rows"], counts["_branching_rows"]) > 0
    assert counts["_nw_pairs"] > counts["_blocks"]


@pytest.mark.parametrize("fault, number", [
    (tri_row_altered, "multi_rows_off"), (tetra_row_dropped, SITE_NUMBERS),
    (branching_frequency_altered, "branching_rows_off"), (gap_moved, "align_off"),
    (three_branch_block_removed, "multi_rows_off"),
    (gapped_bubbles_dropped, ("strict_rows_off", "multi_rows_off", "branching_rows_off"))])
def test_tetraploid_fault_is_not_correct(tmp_path, monkeypatch, fault, number):
    res = drive(tmp_path, TETRAPLOID["name"], fault=lambda: fault(monkeypatch))
    assert res["correct"] is False
    numbers = number if isinstance(number, tuple) else (number,)
    assert sum(res["checks"][n]["value"] for n in numbers) > 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, count_altered, fit_altered,
                                   unitig_dropped, site_row_altered])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault):
    res = drive(tmp_path, fault=lambda: fault(monkeypatch))
    assert res["correct"] is False
    assert any(r["value"] > r["limit"] for r in res["checks"].values()) or res["failed"]


@pytest.mark.parametrize("fault", [half_batch, seeds_halved])
def test_colored_fault_is_not_correct(tmp_path, monkeypatch, fault):
    res = drive(tmp_path, "snj3.full", fault=lambda: fault(monkeypatch))
    assert res["correct"] is False


def test_seeds_halved_shows_in_the_superbubbles(tmp_path, monkeypatch):
    res = drive(tmp_path, fault=lambda: seeds_halved(monkeypatch))
    assert res["correct"] is False
    assert res["checks"]["bubbles_off"]["value"] > 0
