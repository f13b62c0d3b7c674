"""The interval union, the idle gaps and the roofline counts, on hand-made
traces and against the operations the port's CPU prove really runs."""
import importlib

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu_torch.ops import commit, ntt, poseidon
from portbench.metrics import ntt_roofline, poseidon_gl_roofline
from portbench.port import Prover
from portbench.record import Run, Shapes
from portbench.reference.layout import Layout
from portbench.trace import Events, Window, gaps, union

CPU = torch.device("cpu")


def _events(pairs, names=None):
    s = np.array([a for a, _ in pairs], dtype=np.int64)
    e = np.array([b for _, b in pairs], dtype=np.int64)
    return Events(names or ["k"] * len(pairs), s, e)


def test_union_merges_overlaps_and_clips():
    s, e = union(np.array([5, 0, 2, 20, 30]), np.array([9, 3, 4, 25, 40]),
                 1, 35)
    assert s.tolist() == [1, 5, 20, 30] and e.tolist() == [4, 9, 25, 35]
    gs, ge = gaps(s, e, 0, 50)
    assert list(zip(gs.tolist(), ge.tolist())) == [(0, 1), (4, 5), (9, 20),
                                                   (25, 30), (35, 50)]


def test_union_of_nothing():
    s, e = union(np.array([], dtype=np.int64), np.array([], dtype=np.int64),
                 0, 10)
    assert s.size == 0
    gs, ge = gaps(s, e, 0, 10)
    assert gs.tolist() == [0] and ge.tolist() == [10]


def test_window_busy_idle_and_labels():
    ev = _events([(0, 400), (100, 500), (700, 800), (900, 1000)],
                 ["ntt_leaf_kernel<true>", "Memcpy HtoD", "poseidon_gl_kernel",
                  "ntt_leaf_kernel<false>"])
    w = Window(0, 1000, ev, [("a", 0, 650), ("b", 650, 880)])
    assert w.seconds == 1e-6
    assert w.busy_seconds() == pytest.approx(700e-9)
    assert ev.kernels.tolist() == [True, False, True, True]
    assert ev.seconds_of("ntt_leaf") == pytest.approx(500e-9)
    assert w.idle_by_stage() == [["a", pytest.approx(200e-9)],
                                 ["b", pytest.approx(100e-9)]]
    w.stages = [("a", 0, 650)]
    assert w.idle_by_stage()[1] == ["between proofs", pytest.approx(100e-9)]
    assert w.top_ops(2)[0] == ["ntt_leaf_kernel<true>", 400e-9]


def _shapes(name, nbits):
    cfg = importlib.import_module(f"portbench.configs.{name}")
    c = cfg.circuit(nbits)
    return cfg, c, Shapes.of(Layout.of(c.pil_json, c.struct_json),
                             c.struct_json)


@pytest.mark.parametrize("name,nbits", [("chain_gl_2e23x8", 6),
                                        ("plookup_gl_2e22", 6)])
def test_roofline_counts_match_the_port_prove(name, nbits, monkeypatch):
    """The transforms' butterflies and the permutations counted from the
    shapes are those that the port's stark_gen runs on the CPU (the const
    tree, made in set-up, left out)."""
    cfg, c, sh = _shapes(name, nbits)
    prover = Prover(c, CPU)
    seen = {"butterflies": 0, "perms": 0}
    leaf, perm = ntt.leaf_plain, poseidon._permute_rows

    def count_leaf(x, log_n, *a, **k):
        seen["butterflies"] += log_n * (1 << log_n) // 2 * x.shape[1]
        return leaf(x, log_n, *a, **k)

    def count_perm(state):
        seen["perms"] += state.shape[0]
        return perm(state)

    monkeypatch.setattr(ntt, "leaf_plain", count_leaf)
    monkeypatch.setattr(poseidon, "_permute_rows", count_perm)
    t = cfg.traces(c, 3, 1, CPU)[0]
    prover.prove(prover.trace(t))
    want = sum(m * (1 << m) // 2 * cols
               for m, cols, _, _ in ntt_roofline.transforms(sh))
    assert seen["butterflies"] == want
    assert seen["perms"] == poseidon_gl_roofline.permutations(sh)


def test_leaf_calls_match_the_linear_hash(monkeypatch):
    calls = {"n": 0}
    plain = poseidon.hash_n_plain

    def count(inp, cap=None):
        calls["n"] += 1
        return plain(inp, cap)

    monkeypatch.setattr(poseidon, "hash_n", lambda inp, cap=None, out=None:
                        count(inp, cap))
    for w in (1, 4, 5, 8, 9, 12, 24, 33, 96, 375):
        calls["n"] = 0
        poseidon.hash_leaves(torch.zeros((1, w), dtype=torch.int64), w)
        assert calls["n"] == poseidon_gl_roofline.leaf_calls(w), w


@pytest.mark.parametrize("height", [1, 2, 3, 5, 8, 13, 64])
def test_node_calls_match_the_level_layout(height):
    sizes, _ = commit.level_layout(height)
    assert poseidon_gl_roofline.node_calls(height) == sum(sizes[1:])


def test_rooflines_read_nothing_without_their_kernels():
    _, _, sh = _shapes("chain_gl_2e23x8", 6)
    w = Window(0, 10**9, _events([(0, 10)], ["elementwise_kernel"]))
    run = Run(1.0, 1.0, 2, 0, sh, [], w)
    assert ntt_roofline.read(run) is None
    assert poseidon_gl_roofline.read(run) is None
    assert ntt_roofline.read(Run(1.0, 1.0, 2, 0, sh, [], None)) is None


def test_roofline_share_is_least_time_over_kernel_time():
    _, _, sh = _shapes("chain_gl_2e23x8", 6)
    least = ntt_roofline.least_seconds(sh)
    ns = int(least * 4 * 1e9)  # two proofs at about half the roofline each
    w = Window(0, 10**9, _events([(0, ns)], ["ntt_leaf_kernel<false>"]))
    run = Run(1.0, 1.0, 2, 0, sh, [], w)
    assert ntt_roofline.read(run) == pytest.approx(100 * least * 2e9 / ns)
    assert ntt_roofline.read(run) == pytest.approx(50.0, rel=0.05)
