"""The port's device executor (eigen_zkvm_tpu_torch/ops/vm.py) on CPU
tensors against the JAX package's: ops/vm_jax.py on JAX's CPU backend, and
the numpy stark/vm.py for the rest (their XLA:CPU compiles take a minute
or more each).  Every section of the examples' PILs starts from the same
random field values, made with numpy from a seed; each segment must write
the same values bit for bit.  Also held: the domain vectors, the Lagrange
vectors, the openings and xDivXSubXi, and the compiled Program itself."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from eigen_zkvm_tpu.examples import (connection, fibonacci, permutation,
                                     plookup, poseidon)
from eigen_zkvm_tpu.fields import f3g
from eigen_zkvm_tpu.ops import vm_jax
from eigen_zkvm_tpu.stark import vm as np_vm
from eigen_zkvm_tpu.stark.starkinfo import StarkInfo as JaxStarkInfo
from eigen_zkvm_tpu.stark.types import StarkStruct, Step
from eigen_zkvm_tpu_torch.ops import gl, vm
from eigen_zkvm_tpu_torch.stark.starkinfo import StarkInfo

P = 0xFFFFFFFF00000001
CPU = torch.device("cpu")
SEGMENTS = [("step2prev", "n"), ("step3prev", "n"), ("step3", "n"),
            ("step42ns", "2ns"), ("step52ns", "2ns")]


def _pil(name, nbits=5):
    if name == "poseidon":
        pil, *_ = poseidon.build(6)
        return pil, 6
    mod = {"fibonacci": fibonacci, "plookup": plookup,
           "permutation": permutation, "connection": connection}[name]
    pil, *_ = mod.build(nbits)
    return pil, nbits


def _ss(nbits):
    return StarkStruct(nBits=nbits, nBitsExt=nbits + 1, nQueries=2,
                       verificationHashType="GL",
                       steps=[Step(nbits + 1), Step(3)])


def _compile(name, nbits=5):
    pil, nbits = _pil(name, nbits)
    ss = _ss(nbits)
    return (StarkInfo(copy.deepcopy(pil), ss),
            JaxStarkInfo(copy.deepcopy(pil), ss), ss)


def _rand(rng, *shape):
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def _contexts(psi, jsi, ss, seed):
    """A JAX-package ProverContext (numpy sections) and the port's, holding
    the same random values in every buffer a segment may read."""
    rng = np.random.default_rng(seed)
    jctx = np_vm.ProverContext(jsi, ss)
    N, Next = jctx.N, jctx.Next
    for name, buf in jctx.sections.items():
        buf[:, :] = _rand(rng, *buf.shape)
    jctx.x_n = _rand(rng, N)
    jctx.x_2ns = _rand(rng, Next)
    jctx.zhinv_2ns = _rand(rng, Next)
    jctx.challenges = _rand(rng, 8, 3)
    jctx.publics = _rand(rng, len(jsi.publics), 3)
    jctx.evals = _rand(rng, len(jsi.ev_map), 3)
    jctx.x_div_x_sub_xi = _rand(rng, Next, 3)
    jctx.x_div_x_sub_wxi = _rand(rng, Next, 3)

    pctx = vm.ProverContext(psi, ss, CPU)
    for name, buf in jctx.sections.items():
        pctx.sections[name] = gl.from_u64(buf.copy())
    for name in ("x_n", "x_2ns", "zhinv_2ns", "x_div_x_sub_xi",
                 "x_div_x_sub_wxi"):
        setattr(pctx, name, gl.from_u64(getattr(jctx, name).copy()))
    for name in ("challenges", "publics", "evals"):
        setattr(pctx, name, getattr(jctx, name).copy())
    return pctx, jctx


def _assert_sections_equal(pctx, jctx):
    for name, buf in jctx.sections.items():
        assert np.array_equal(gl.to_u64(pctx.sections[name]), buf), name


def _run_both(name, seg, dom, jax_run):
    psi, jsi, ss = _compile(name)
    pctx, jctx = _contexts(psi, jsi, ss, seed=len(name) * 7 + len(seg))
    assert getattr(psi.program, seg).first, f"{name} has no {seg} code"
    vm.execute_segment(pctx, getattr(psi.program, seg), dom)
    jax_run(jctx, getattr(jsi.program, seg), dom)
    _assert_sections_equal(pctx, jctx)


# (PIL, segment) pairs whose XLA:CPU compile takes seconds, not minutes:
# every segment kind once, step52ns on the smallest PIL
JAX_CASES = [("plookup", "step2prev"), ("permutation", "step3prev"),
             ("connection", "step3"), ("fibonacci", "step42ns"),
             ("fibonacci", "step52ns")]
# segments these PILs compile to no code
EMPTY = {("permutation", "step2prev"), ("permutation", "step3"),
         ("connection", "step2prev"), ("poseidon", "step2prev"),
         ("poseidon", "step3prev")}
NUMPY_CASES = [(name, seg) for name in ("plookup", "permutation",
                                        "connection", "poseidon")
               for seg, _ in SEGMENTS
               if (name, seg) not in JAX_CASES and (name, seg) not in EMPTY]
DOM = dict(SEGMENTS)


@pytest.mark.parametrize("name,seg", JAX_CASES)
def test_segment_matches_vm_jax(name, seg):
    _run_both(name, seg, DOM[seg], vm_jax.execute_segment)


@pytest.mark.parametrize("name,seg", NUMPY_CASES)
def test_segment_matches_numpy_vm(name, seg):
    _run_both(name, seg, DOM[seg], np_vm.execute_segment)


@pytest.mark.parametrize("name", ["fibonacci", "plookup", "permutation",
                                  "connection", "poseidon"])
def test_program_equals_jax_package_op_for_op(name):
    psi, jsi, _ = _compile(name)
    assert dataclasses.asdict(psi.program) == dataclasses.asdict(jsi.program)
    assert [dataclasses.asdict(p) for p in psi.var_pol_map] \
        == [dataclasses.asdict(p) for p in jsi.var_pol_map]
    assert psi.q_deg == jsi.q_deg and psi.q_dim == jsi.q_dim


def test_seed_domains_matches_vm_jax():
    psi, jsi, ss = _compile("fibonacci")
    pctx, jctx = _contexts(psi, jsi, ss, seed=1)
    vm.seed_domains(pctx)
    vm_jax.seed_domains(jctx)
    for name in ("x_n", "x_2ns", "zhinv_2ns"):
        assert np.array_equal(gl.to_u64(getattr(pctx, name)),
                              vm_jax._join64(*jctx._tpu_cache[name])), name


def _point(rng):
    return tuple(int(x) for x in _rand(rng, 3))


def test_levs_evals_xdiv_match_vm_jax():
    psi, jsi, ss = _compile("fibonacci", 3)
    pctx, jctx = _contexts(psi, jsi, ss, seed=2)
    rng = np.random.default_rng(3)
    xis, wxis, xi, wxi = (_point(rng) for _ in range(4))
    levs = vm.compute_levs(pctx, xis, wxis)
    jlevs = vm_jax.compute_levs(jctx, np.array(xis, dtype=np.uint64),
                                np.array(wxis, dtype=np.uint64))
    for got, want in zip(levs, jlevs):
        assert np.array_equal(gl.to_u64(got), vm_jax._join64(*want))
    evals = vm.compute_evals(pctx, *levs)
    assert evals.shape == (len(jsi.ev_map), 3)
    assert np.array_equal(evals, vm_jax.compute_evals(jctx, *jlevs))
    got = vm.compute_xdiv(pctx, xi, wxi)
    want = vm_jax.compute_xdiv(jctx, np.array(xi, dtype=np.uint64),
                               np.array(wxi, dtype=np.uint64))
    for g, w in zip(got, want):
        assert np.array_equal(gl.to_u64(g), w)
    # and against the definition, x / (x - xi)
    x = f3g.from_base(jctx.x_2ns[:5])
    pt = np.array(xi, dtype=np.uint64)
    assert np.array_equal(gl.to_u64(got[0])[:5],
                          f3g.mul(x, f3g.inv(f3g.sub(x, pt[None, :]))))


def test_copy_snapshots_its_source():
    """A tmp copied from a column keeps its value when the column is
    written later in the same segment."""
    from eigen_zkvm_tpu_torch.stark.starkinfo_codegen import Node, Section

    psi, jsi, ss = _compile("fibonacci")
    pctx, _ = _contexts(psi, jsi, ss, seed=4)
    p = psi.var_pol_map[psi.cm_n[0]]
    col = pctx.sections[p.section][:, p.section_pos].clone()
    ops = [Section("copy", Node("tmp", id=0), [Node("cm", id=0)]),
           Section("copy", Node("cm", id=0), [Node("number", value="5")]),
           Section("copy", Node("tmp", id=1), [Node("tmp", id=0)])]
    tmps = vm._run_ops(pctx, ops, "n")
    assert torch.equal(tmps[1][0][:, 0], col)
    assert torch.all(pctx.sections[p.section][:, p.section_pos] == 5)
