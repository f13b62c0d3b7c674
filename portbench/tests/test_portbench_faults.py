"""A whole run on the CPU at a small size (the harness's look for a card
skipped), with the timed path broken underneath: `correct` must come out
false for each fault a serial prover can have, and for the control (the
program with one FRI query fewer than the configuration states).  A cell
on one chip has no exchange between chips to leave out."""
import time

import numpy as np
import pytest
import torch

from portbench import control, port, run
from portbench.reference.field import P as P_INT

CPU = torch.device("cpu")
CELLS = [("chain_gl_2e23x8.serial", 6), ("plookup_gl_2e22.serial", 5)]


def _run(cell, nbits, seconds=0.05):
    bench = run.load_benchmark()
    return run.run(bench, run.cell_of(bench, cell), 2**31 + 1234, seconds,
                   False, CPU, time.perf_counter(), nbits=nbits)


def _wrap(monkeypatch, fault, warmup_too=False):
    """Break stark_gen in the window (the warm-up proof sound, unless
    `warmup_too`)."""
    real, calls = port.stark_gen, []

    def broken(cm, *a, **k):
        calls.append(1)
        if len(calls) == 1 and not warmup_too:
            return real(cm, *a, **k)
        return fault(real, cm, *a, **k)
    monkeypatch.setattr(port, "stark_gen", broken)


def altered_answer(real, cm, *a, **k):
    """One opening changed where the prover produces it."""
    proof = real(cm, *a, **k)
    proof.evals = proof.evals.copy()
    proof.evals[0, 0] = np.uint64((int(proof.evals[0, 0]) + 1) % P_INT)
    return proof


def stale_state():
    """Each call returns the state it was left in: the proof of the call
    before it (of the previous ring entry)."""
    prev = []

    def fault(real, cm, *a, **k):
        proof = real(cm, *a, **k)
        out = prev[0] if prev else proof
        prev[:] = [proof]
        return out
    return fault


def half_batch(real, cm, *a, **k):
    """The prover sees half the trace's rows; the rest are left out."""
    class Half:
        def write_buff(self):
            buf = cm.write_buff().copy()
            buf[buf.shape[0] // 2:] = 0
            return buf
    return real(Half(), *a, **k)


@pytest.mark.parametrize("cell,nbits", CELLS)
def test_a_sound_run_is_correct(cell, nbits):
    res = _run(cell, nbits)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["checked_proofs"]["value"] >= 1
    assert list(res["metrics"]) == ["setup_s", "prove_s", "peak_gib"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,nbits", CELLS)
@pytest.mark.parametrize("fault", ["altered_answer", "stale_state",
                                   "half_batch"])
def test_a_broken_prover_is_not_correct(cell, nbits, fault, monkeypatch):
    f = {"altered_answer": altered_answer, "stale_state": stale_state(),
         "half_batch": half_batch}[fault]
    _wrap(monkeypatch, f, warmup_too=fault == "stale_state")
    res = _run(cell, nbits, seconds=0.0)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["wrong_proofs"]["value"] + \
        checks["failed_proofs"]["value"] >= 1


@pytest.mark.parametrize("cell,nbits", CELLS)
def test_the_control_is_not_correct(cell, nbits, monkeypatch):
    """The control: the program proving with one FRI query fewer."""
    real = port.Prover.__init__

    def weak(self, c, device):
        real(self, control.control_circuit(c), device)
    monkeypatch.setattr(port.Prover, "__init__", weak)
    res = _run(cell, nbits)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["wrong_proofs"]["value"] == \
        checks["checked_proofs"]["value"] >= 1
