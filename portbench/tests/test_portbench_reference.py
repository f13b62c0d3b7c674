"""The reference: its Goldilocks tensors against Python ints, its
Poseidon on tensors against its Poseidon on ints, its roots against the
port's, its verifier accepting the port's CPU proofs and rejecting every
kind of altered one, and the control's proof rejected."""
import importlib
import json
import random

import pytest
import torch

from portbench import control
from portbench.port import Prover
from portbench.reference import field as F
from portbench.reference import merkle, poseidon, tensor_gl as tg
from portbench.reference import verify as ref
from portbench.reference.layout import Layout

CPU = torch.device("cpu")
EDGES = [0, 1, 2, F.P - 1, F.P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         (1 << 63) - 1, 1 << 63, (1 << 63) + 1, F.P >> 1]


def _t(vals):
    return torch.tensor([tg.as_i64(v) for v in vals], dtype=torch.int64)


def _ints(t):
    return [int(v) % (1 << 64) for v in t.tolist()]


def test_tensor_arithmetic_matches_python_ints():
    rng = random.Random(5)
    a = EDGES + [rng.randrange(F.P) for _ in range(500)]
    b = list(reversed(EDGES)) + [rng.randrange(F.P) for _ in range(500)]
    ta, tb = _t(a), _t(b)
    assert _ints(tg.add(ta, tb)) == [(x + y) % F.P for x, y in zip(a, b)]
    assert _ints(tg.sub(ta, tb)) == [(x - y) % F.P for x, y in zip(a, b)]
    assert _ints(tg.mul(ta, tb)) == [x * y % F.P for x, y in zip(a, b)]


def test_lde_is_the_coset_evaluation():
    rng = random.Random(6)
    vals = [[rng.randrange(F.P) for _ in range(2)] for _ in range(8)]
    x = torch.tensor([[tg.as_i64(v) for v in r] for r in vals])
    got = tg.lde(x, 3, 4)
    w, w_ext = F.root_of_unity(3), F.root_of_unity(4)
    for col in range(2):
        coef = [sum(vals[j][col] * pow(w, -j * k, F.P) for j in range(8))
                * F.inv(8) % F.P for k in range(8)]
        for i in range(16):
            pt = F.SHIFT * pow(w_ext, i, F.P)
            want = sum(c * pow(pt, k, F.P) for k, c in enumerate(coef)) % F.P
            assert int(got[i, col]) % (1 << 64) == want


def test_poseidon_on_tensors_matches_poseidon_on_ints():
    rng = random.Random(7)
    states = [[rng.choice(EDGES + [rng.randrange(F.P)]) for _ in range(12)]
              for _ in range(6)]
    cols = [_t([s[i] for s in states]) for i in range(12)]
    out = [_ints(c) for c in poseidon.permute_cols(cols)]
    for r, s in enumerate(states):
        assert [out[i][r] for i in range(12)] == poseidon.permute(s)


@pytest.mark.parametrize("width", [1, 4, 5, 8, 9, 24, 33, 96])
def test_leaves_on_tensors_match_leaves_on_ints(width):
    rng = random.Random(width)
    rows = [[rng.randrange(F.P) for _ in range(width)] for _ in range(3)]
    t = torch.tensor([[tg.as_i64(v) for v in r] for r in rows])
    dig = [_ints(c) for c in merkle.leaves(t)]
    assert [[dig[k][r] for k in range(4)] for r in range(3)] == \
        [merkle.leaf(r) for r in rows]


def _case(name, nbits, seed=2**35 + 1):
    cfg = importlib.import_module(f"portbench.configs.{name}")
    c = cfg.circuit(nbits)
    return cfg, c, Prover(c, CPU), cfg.traces(c, seed, 2, CPU)


CASES = [("chain_gl_2e23x8", 6), ("plookup_gl_2e22", 5)]


@pytest.mark.parametrize("name,nbits", CASES)
def test_roots_match_the_port(name, nbits):
    _, c, prover, traces = _case(name, nbits)
    s = c.struct_json
    assert ref.commit_root(c.const, s["nBits"], s["nBitsExt"], CPU) == \
        [int(x) for x in prover.setup.const_tree.root()]
    for t in traces:
        js = json.loads(prover.prove(prover.trace(t)))
        assert ref.commit_root(t, s["nBits"], s["nBitsExt"], CPU) == \
            [int(x) for x in js["root1"]]


def _judge(c, js, trace):
    s = c.struct_json
    croot = ref.commit_root(c.const, s["nBits"], s["nBitsExt"], CPU)
    return ref.verify(js, Layout.of(c.pil_json, s), s, croot,
                      ref.publics_of(c.pil_json, trace))


@pytest.mark.parametrize("name,nbits", CASES + [("plookup_gl_2e22", 7)])
def test_the_port_proofs_verify(name, nbits):
    _, c, prover, traces = _case(name, nbits, seed=2**36 + nbits)
    for t in traces:
        assert _judge(c, prover.prove(prover.trace(t)), t) == []


def _bump(v):
    return str((int(v) + 1) % F.P)


ALTERATIONS = {
    "an opening": lambda p: p["evals"][-1].__setitem__(0, _bump(
        p["evals"][-1][0])),
    "a stage-1 query row": lambda p: p["s0_vals1"][3].__setitem__(0, _bump(
        p["s0_vals1"][3][0])),
    "a quotient query row": lambda p: p["s0_vals4"][0].__setitem__(2, _bump(
        p["s0_vals4"][0][2])),
    "a constants query row": lambda p: p["s0_vals" "C"][1].__setitem__(
        0, _bump(p["s0_valsC"][1][0])),
    "a fold's row": lambda p: p["s1_vals"][2].__setitem__(1, _bump(
        p["s1_vals"][2][1])),
    "a sibling": lambda p: p["s0_siblings2"][5][0].__setitem__(0, _bump(
        p["s0_siblings2"][5][0][0])),
    "the last polynomial": lambda p: p["finalPol"][0].__setitem__(0, _bump(
        p["finalPol"][0][0])),
    "a stage root": lambda p: p["root3"].__setitem__(0, _bump(p["root3"][0])),
    "a missing query": lambda p: p["s0_vals1"].pop(),
}


@pytest.mark.parametrize("name,nbits", CASES)
@pytest.mark.parametrize("what", sorted(ALTERATIONS))
def test_an_altered_proof_is_rejected(name, nbits, what):
    _, c, prover, traces = _case(name, nbits)
    pf = json.loads(prover.prove(prover.trace(traces[0])))
    ALTERATIONS[what](pf)
    assert _judge(c, json.dumps(pf), traces[0]) != []


def test_another_traces_proof_is_rejected_by_its_publics():
    _, c, prover, traces = _case("chain_gl_2e23x8", 6)
    js = prover.prove(prover.trace(traces[1]))
    assert "publics" in _judge(c, js, traces[0])


@pytest.mark.parametrize("name,nbits", CASES)
def test_the_control_is_rejected(name, nbits):
    _, c, _, traces = _case(name, nbits)
    weak = Prover(control.control_circuit(c), CPU)
    js = weak.prove(weak.trace(traces[0]))
    assert len(json.loads(js)["s0_vals1"]) == c.struct_json["nQueries"] - 1
    assert _judge(c, js, traces[0]) != []
