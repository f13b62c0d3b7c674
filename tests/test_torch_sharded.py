"""The port's multi-rank prover (eigen_zkvm_tpu_torch/parallel/) on the CPU
against the JAX package: fold_root_pow2, the sharded commit on (2, 2) and
(1, 4) grids, the halo roll and the distributed grand product, and
four-rank sharded proves of the chain AIR and of the plookup and
permutation examples, byte for byte.

One pool of four gloo ranks (one torch thread each) serves the whole file;
the ranks run the module-level `_*_task` functions, so they import this
module, and this module imports the JAX package only inside the tests:
the parent process does every JAX comparison.  Inputs are seeded numpy
draws; tolerance 0 (field integers)."""
import numpy as np
import pytest
import torch

from eigen_zkvm_tpu_torch.ops import f3, gl, poseidon
from eigen_zkvm_tpu_torch.parallel import launch

WORLD = 4
P = 0xFFFFFFFF00000001


def _rand(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=shape, dtype=np.uint64) % np.uint64(P)


def _pair(a):
    import jax.numpy as jnp

    return (jnp.asarray((a & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((a >> np.uint64(32)).astype(np.uint32)))


def _join(pair):
    lo, hi = (np.asarray(x).astype(np.uint64) for x in pair)
    return lo | (hi << np.uint64(32))


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(WORLD, "gloo", device="cpu", threads=1) as p:
        yield p


# ---- the launcher's devices

def test_rank_devices_are_cards_unless_the_caller_asks_for_the_cpu(
        monkeypatch):
    """A rank's device is card LOCAL_RANK mod the cards (read before the
    group exists); without a card it raises unless given "cpu"; NCCL
    refuses a CPU rank; a spawned pool with no card raises."""
    from eigen_zkvm_tpu_torch.parallel import meshctx

    monkeypatch.setenv("LOCAL_RANK", "5")
    assert meshctx.local_rank() == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert meshctx.rank_device("nccl") == torch.device("cuda", 1)
    assert meshctx.rank_device("gloo", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="NCCL"):
        meshctx.rank_device("nccl", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshctx.rank_device("gloo")
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(launch.RankError, match="no CUDA device"):
            launch.spawn(2, _roll_task, np.zeros((4, 1), np.int64), 1)


def test_init_from_env_joins_torchrun_s_group():
    """The torchrun path: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT as torchrun sets them, one gloo rank on the CPU."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               GLOO_SOCKET_IFNAME="lo")
    code = ("import torch.distributed as dist\n"
            "from eigen_zkvm_tpu_torch.parallel import launch\n"
            "m = launch.init_from_env('gloo', device='cpu')\n"
            "print(m.model, m.coords, m.device)\n"
            "dist.destroy_process_group()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["1", "(0,", "0)", "cpu"]


# ---- (a) fold_root_pow2

@pytest.mark.parametrize("shape", [(1, 4), (2, 4), (16, 4), (3, 8, 4)])
def test_fold_root_pow2_matches_jax(shape):
    from eigen_zkvm_tpu.ops import poseidon_jax as pj

    digs = _rand(1, *shape)
    got = gl.to_u64(poseidon.fold_root_pow2(gl.from_u64(digs)))
    assert np.array_equal(got, _join(pj.fold_root_pow2(_pair(digs))))


# ---- (b) make_sharded_commit

def _commit_task(mesh, vals, nbits, nbits_ext):
    from eigen_zkvm_tpu_torch.parallel.sharded import make_sharded_commit

    d, j = mesh.coords
    b_l, p_l = vals.shape[0] // mesh.data, vals.shape[2] // mesh.model
    local = gl.from_u64(vals[d * b_l : (d + 1) * b_l, :,
                             j * p_l : (j + 1) * p_l])
    commit = make_sharded_commit(mesh, nbits, nbits_ext, vals.shape[2])
    return gl.to_u64(commit(local))


@pytest.mark.parametrize("data", [2, 1])
def test_sharded_commit_matches_host_merkle(pool, data):
    """(2, 2) and (1, 4) grids, nbits 4 -> 5, n_pols = 2 * model: every
    rank's roots equal its data row's host Merkle roots."""
    from eigen_zkvm_tpu.hash.merkle_gl import MerkleTreeGL
    from eigen_zkvm_tpu.poly import ntt as ntt_np

    nbits, nbits_ext = 4, 5
    model = WORLD // data
    n_pols, B = 2 * model, 2 * data
    vals = _rand(7, B, 1 << nbits, n_pols)
    want = np.stack([np.asarray(MerkleTreeGL().merkelize(
        ntt_np.interpolate(vals[b], nbits, nbits_ext), n_pols,
        1 << nbits_ext).root(), dtype=np.uint64) for b in range(B)])
    got = pool.run(_commit_task, vals, nbits, nbits_ext, data=data)
    for rank, roots in enumerate(got):
        d = rank // model
        assert np.array_equal(roots, want[d * 2 : (d + 1) * 2]), rank


def _indivisible_task(mesh):
    from eigen_zkvm_tpu_torch.parallel.sharded import make_sharded_commit

    try:
        make_sharded_commit(mesh, 4, 5, 3)
    except ValueError as e:
        return str(e)
    return None


def test_sharded_commit_rejects_a_width_the_axis_does_not_divide(pool):
    assert all(msg and "n_pols=3" in msg
               for msg in pool.run(_indivisible_task))


# ---- (c) the halo roll and the distributed grand product

def _roll_task(mesh, full, k):
    r0, n = mesh.block(full.shape[0])
    return mesh.roll(torch.from_numpy(full[r0 : r0 + n]), k).numpy()


@pytest.mark.parametrize("k", [1, 2, -1, -2])
def test_halo_roll_matches_torch_roll(pool, k):
    full = np.arange(16 * 3, dtype=np.int64).reshape(16, 3) * 7 + 1
    got = np.concatenate(pool.run(_roll_task, full, k))
    assert np.array_equal(got, torch.roll(torch.from_numpy(full), -k,
                                          dims=0).numpy())


def _scan_task(mesh, vals):
    r0, n = mesh.block(vals.shape[0])
    block = gl.from_u64(vals[r0 : r0 + n])
    acc, before, total = f3.prefix_product_sharded(block, mesh)
    whole = f3.prefix_product(mesh.replicated(block))  # the gathered column
    return (gl.to_u64(acc), gl.to_u64(whole[r0 : r0 + n]),
            gl.to_u64(before), gl.to_u64(total), gl.to_u64(whole[-1]))


def test_distributed_grand_product_matches_prefix_product(pool):
    vals = _rand(3, 32, 3)
    got = pool.run(_scan_task, vals)
    want = gl.to_u64(f3.prefix_product(gl.from_u64(vals)))
    assert np.array_equal(np.concatenate([g[0] for g in got]), want)
    for rank, (acc, whole, before, total, last) in enumerate(got):
        assert np.array_equal(acc, whole)
        r0 = rank * 8
        assert np.array_equal(before, want[r0 - 1] if r0 else [1, 0, 0])
        assert np.array_equal(total, last) and np.array_equal(total, want[-1])


def _z_task(mesh, num, den):
    from eigen_zkvm_tpu_torch.stark.stark_gen import calculate_z

    r0, n = mesh.block(num.shape[0])
    return gl.to_u64(calculate_z(gl.from_u64(num[r0 : r0 + n]),
                                 gl.from_u64(den[r0 : r0 + n]), mesh))


def test_sharded_calculate_z_matches_single_device(pool):
    """Z of num / den with den a permutation of num (product 1), and a
    changed den raising on every rank."""
    from eigen_zkvm_tpu_torch.stark.stark_gen import calculate_z

    num = _rand(5, 32, 3)
    den = num[np.random.default_rng(6).permutation(32)]
    want = gl.to_u64(calculate_z(gl.from_u64(num), gl.from_u64(den)))
    assert np.array_equal(np.concatenate(pool.run(_z_task, num, den)), want)
    bad = den.copy()
    bad[5, 1] ^= np.uint64(1)
    with pytest.raises(launch.RankError, match="grand product is not 1"):
        launch.spawn(WORLD, _z_task, num, bad, device="cpu", threads=1)


# ---- (d), (e) four-rank sharded proves against the JAX host engine

def _struct(nbits, queries, steps):
    from eigen_zkvm_tpu_torch.stark.types import StarkStruct, Step

    return StarkStruct(nBits=nbits, nBitsExt=nbits + 1, nQueries=queries,
                       verificationHashType="GL",
                       steps=[Step(s) for s in steps])


def _air(name):
    """(pil, const, cm, stark struct) of the port's AIRs: the chain AIR of
    tests/test_sharded_prove.py (NB = 7, W = 8, 4 queries, steps [8, 3]),
    or an example at 2^5."""
    if name == "chain":
        from eigen_zkvm_tpu_torch import bench_chain

        return (*bench_chain.build_chain_air(7, 8), _struct(7, 4, [8, 3]))
    import importlib

    mod = importlib.import_module(f"eigen_zkvm_tpu_torch.examples.{name}")
    pil, cp, mk = mod.build(5)
    return pil, cp, mk(), _struct(5, 3, [6, 3])


def _prove_task(mesh, name):
    from eigen_zkvm_tpu_torch.parallel.sharded_prove import sharded_prove
    from eigen_zkvm_tpu_torch.stark.engine import Engine
    from eigen_zkvm_tpu_torch.stark.serializer import stark_proof_to_json
    from eigen_zkvm_tpu_torch.stark.stark_setup import StarkSetup

    pil, cp, cm, ss = _air(name)
    setup = StarkSetup(cp, pil, ss, Engine("cpu"))
    proof = sharded_prove(cm, cp, setup, ss, mesh)
    return stark_proof_to_json(proof), proof, dict(mesh.stats)


def _host(name, monkeypatch):
    from eigen_zkvm_tpu.stark import stark_gen as host_gen
    from eigen_zkvm_tpu.stark import stark_setup as host_setup
    from eigen_zkvm_tpu.stark.serializer import stark_proof_to_json

    monkeypatch.setenv("EIGEN_ZKVM_ENGINE", "host")
    pil, cp, cm, ss = _air(name)
    setup = host_setup.StarkSetup(cp, pil, ss)
    proof = host_gen.stark_gen(cm, cp, setup.const_tree, setup.starkinfo,
                               setup.program, ss)
    return stark_proof_to_json(proof), setup, ss


@pytest.mark.parametrize("name", ["chain", "plookup", "permutation"])
def test_sharded_prove_is_byte_identical_to_host_engine(pool, monkeypatch,
                                                        name):
    """Every rank's proof JSON equals the JAX host engine's; the chain
    AIR's proof is accepted by the JAX verifier, and the plookup and
    permutation AIRs cross h1/h2 and the grand products over blocks."""
    from eigen_zkvm_tpu.stark.stark_verify import stark_verify

    want, setup, ss = _host(name, monkeypatch)
    got = pool.run(_prove_task, name)
    for text, _, stats in got:
        assert text == want
        assert stats["all_to_all"][0] > 0 and stats["all_gather"][0] > 0
    if name == "chain":
        assert stark_verify(got[0][1], setup.const_root, setup.starkinfo,
                            ss, setup.program)
