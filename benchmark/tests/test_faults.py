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


def drive(tmp_path, cell_name="snj17.full", seed=2**31 + 11, fault=None):
    cell = spec.cell(cell_name, BENCH)
    cfg = tiny(spec.config(cell["config"], BENCH), 40_000)
    here = os.getcwd()
    try:
        r = run.run_cell(cell, cfg, spec.traffic(cell["traffic"]), seed, 0.0, False, "cpu",
                         time.time(), spec.limits(), BENCH, str(tmp_path), processes=1,
                         after_setup=fault)
    finally:
        os.chdir(here)
    return r["result"]


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


def seeds_halved(monkeypatch):
    """The superbubble search drops every other seed it was given."""
    from ploidyfrost_tpu_torch.bubble import batched

    seeds = batched.canonical_seeds
    monkeypatch.setattr(batched, "canonical_seeds", lambda g: seeds(g)[::2])


def test_sound_run_is_correct(tmp_path):
    res = drive(tmp_path)
    assert res["correct"], res["checks"]


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
