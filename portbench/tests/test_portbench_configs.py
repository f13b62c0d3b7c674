"""Each configuration builds and proves at small sizes on the CPU, and its
trace maker is deterministic for a seed and satisfies its AIR."""
import importlib
import os

import numpy as np
import pytest
import torch

from portbench.port import Prover
from portbench.reference.field import P

CPU = torch.device("cpu")


def _cfg(name):
    return importlib.import_module(f"portbench.configs.{name}")


@pytest.mark.parametrize("name,nbits", [("chain_gl_2e23x8", 6),
                                        ("chain_gl_2e23x8", 8),
                                        ("plookup_gl_2e22", 5),
                                        ("plookup_gl_2e22", 6)])
def test_config_builds_and_proves(name, nbits):
    cfg = _cfg(name)
    c = cfg.circuit(nbits)
    assert c.const.shape == (1 << nbits, c.pil_json["nConstants"])
    prover = Prover(c, CPU)
    bufs = cfg.traces(c, 2**31 + 11, 2, CPU)
    a, b = (prover.prove(prover.trace(t)) for t in bufs)
    assert a.startswith('{"rootC"') and a != b


@pytest.mark.parametrize("name", ["chain_gl_2e23x8", "plookup_gl_2e22"])
def test_traces_are_deterministic_per_seed(name):
    cfg = _cfg(name)
    c = cfg.circuit(6)
    one = cfg.traces(c, 2**33 + 5, 3, CPU)
    two = cfg.traces(c, 2**33 + 5, 3, CPU)
    other = cfg.traces(c, 2**33 + 6, 3, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(one, two))
    assert not any(np.array_equal(x, y) for x, y in zip(one, other))
    assert not np.array_equal(one[0], one[1])
    assert all(t.dtype == np.uint64 and (t < P).all() for t in one)


def test_chain_traces_satisfy_the_air():
    cfg = _cfg("chain_gl_2e23x8")
    c = cfg.circuit(7)
    for t in cfg.traces(c, 12345, 3, CPU):
        for j in range(t.shape[1]):
            col = [int(v) for v in t[:, j]]
            assert col[0] != 0
            assert all(col[i + 1] == (j + 2) * col[i] % P
                       for i in range(len(col) - 1))


def test_plookup_traces_satisfy_the_air():
    cfg = _cfg("plookup_gl_2e22")
    c = cfg.circuit(8)
    ref = c.pil_json["references"]
    col = {k: ref[f"Plookup.{k}"]["id"] for k in ("sel", "a", "b", "cc")}
    cst = {k: ref[f"Plookup.{k}"]["id"] for k in ("SEL", "A", "B")}
    table = {(int(c.const[j, cst["A"]]), int(c.const[j, cst["B"]]))
             for j in range(c.const.shape[0]) if c.const[j, cst["SEL"]]}
    n = c.const.shape[0]
    assert len(table) == n // 2
    for t in cfg.traces(c, 99, 2, CPU):
        sel = t[:, col["sel"]]
        assert sel.sum() == len([i for i in range(n - 1) if i % 3 != 2])
        cc = {j: int(t[j, col["cc"]]) for j in range(n // 2)}
        for i in np.flatnonzero(sel):
            a, b1 = int(t[i, col["a"]]), int(t[i + 1, col["b"]])
            assert (a, b1) in table
            assert a * b1 % P == cc[a - 1]


def test_the_kernel_sources_exist():
    from eigen_zkvm_tpu_torch import kernels
    from portbench import port
    for src in port.SOURCES:
        assert os.path.exists(os.path.join(kernels.CSRC, src)), src
