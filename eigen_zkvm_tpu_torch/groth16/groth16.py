"""Groth16 over BN254: circuit-specific setup, prover and verifier, with the
group and field work on tensors.

Port of eigen_zkvm_tpu/groth16/groth16.py (BN254 only).  The same
functions, in the same order, with the same random draws, so that a seeded
rng gives the same keys and the same proof bytes:
  - `setup`: the QAP evaluation at tau on the host (`_eval_qap`, Python
    ints), then the fixed-base batches s_i * G1 and s_i * G2 on the device
    (ops/ec.scalar_mul_batch, kernel 2); the query points stay on the device
    as affine Montgomery words;
  - `prove`: H's coefficients on the device (`_witness_h`: the R1CS rows,
    kernel 4, then the coset transforms and the pointwise quotient, kernel
    3), the five MSMs (ops/ec.msm, kernel 1: A, B1, L and H in G1, B2 in
    G2), and the handful of point combinations on the host;
  - `verify`: the multi-pairing on the host (curves/bn254.py).
`device=None` takes the current CUDA device and raises without one;
`device="cpu"` runs every kernel's plain version.

R1CS constraints are {signal: coef} dict triples with key 0 the one-wire,
the JAX package's convention.
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass

import torch

from ..curves import bn254
from ..ops import bigint as bi
from ..ops import ec, fr_ntt, r1cs
from ..utils.devices import cuda_device
from ..utils.profiler import Prof

R = bn254.R


@dataclass
class ProvingKey:
    curve_name: str
    n_public: int          # public wires excluding the one-wire
    n_vars: int
    domain_size: int
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    delta1: tuple
    delta2: tuple
    a_query: torch.Tensor  # G1 [n_vars, 2, 4]: A_i(tau)
    b1_query: torch.Tensor  # G1 [n_vars, 2, 4]: B_i(tau)
    b2_query: torch.Tensor  # G2 [n_vars, 2, 2, 4]: B_i(tau)
    l_query: torch.Tensor  # G1, private wires: (beta A + alpha B + C)/delta
    h_query: torch.Tensor  # G1 [m - 1, 2, 4]: tau^i Z(tau)/delta


@dataclass
class VerifyingKey:
    curve_name: str
    alpha1: tuple
    beta2: tuple
    gamma2: tuple
    delta2: tuple
    ic: list               # G1 per public wire (incl. one-wire)


@dataclass
class Proof:
    a: tuple               # G1 affine
    b: tuple               # G2 affine
    c: tuple               # G1 affine


def _device(device) -> torch.device:
    """`device`, or the current CUDA device (raises without one)."""
    if device is not None:
        return torch.device(device)
    cuda_device()
    return torch.device("cuda", torch.cuda.current_device())


def _eval_qap(constraints, n_vars, n_pub_total, tau, r, m):
    """A_i(tau), B_i(tau), C_i(tau) for every wire, plus Z(tau), on Python
    ints (groth16._eval_qap).  Rows 0..n_constraints-1 are the
    constraints; rows n_constraints..+n_pub bind the public wires."""
    w = fr_ntt.find_root(r, m)
    z_tau = (pow(tau, m, r) - 1) % r
    m_inv = pow(m, r - 2, r)
    wjs = [0] * m
    wj = 1
    for j in range(m):
        wjs[j] = wj
        wj = wj * w % r
    dens = [(tau - x) % r for x in wjs]
    pref = [0] * m
    acc = 1
    for j in range(m):
        acc = acc * dens[j] % r
        pref[j] = acc
    inv_acc = pow(acc, r - 2, r)
    invs = [0] * m
    for j in range(m - 1, 0, -1):
        invs[j] = inv_acc * pref[j - 1] % r
        inv_acc = inv_acc * dens[j] % r
    invs[0] = inv_acc
    zm = z_tau * m_inv % r
    lj = [zm * wjs[j] % r * invs[j] % r for j in range(m)]
    a_t = [0] * n_vars
    b_t = [0] * n_vars
    c_t = [0] * n_vars
    for j, (A, B, C) in enumerate(constraints):
        for s, coef in A.items():
            a_t[s] = (a_t[s] + coef * lj[j]) % r
        for s, coef in B.items():
            b_t[s] = (b_t[s] + coef * lj[j]) % r
        for s, coef in C.items():
            c_t[s] = (c_t[s] + coef * lj[j]) % r
    nc = len(constraints)
    for i in range(n_pub_total):
        a_t[i] = (a_t[i] + lj[nc + i]) % r
    return a_t, b_t, c_t, z_tau


def setup(constraints, n_vars: int, n_publics: int, rng=None,
          device=None, prof: Prof | None = None
          ) -> tuple[ProvingKey, VerifyingKey]:
    """Circuit-specific trusted setup (groth16.setup)."""
    dev = _device(device)
    prof = prof or Prof("groth16.setup", dev)
    r = R
    rand = rng or (lambda: secrets.randbelow(r - 1) + 1)
    alpha, beta, gamma, delta, tau = (rand() for _ in range(5))
    n_pub_total = n_publics + 1  # one-wire is public
    m = 1
    while m < len(constraints) + n_pub_total:
        m <<= 1
    a_t, b_t, c_t, z_tau = _eval_qap(constraints, n_vars, n_pub_total,
                                     tau, r, m)
    delta_inv = pow(delta, r - 2, r)
    gamma_inv = pow(gamma, r - 2, r)
    ks = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % r
          for i in range(n_vars)]
    tz = []
    tp = 1
    for _ in range(m - 1):
        tz.append(tp * z_tau % r * delta_inv % r)
        tp = tp * tau % r
    g1_scalars = ([alpha, beta, delta] + a_t + b_t
                  + [k * gamma_inv % r for k in ks[:n_pub_total]]
                  + [k * delta_inv % r for k in ks[n_pub_total:]] + tz)
    g2_scalars = [beta, gamma, delta] + b_t
    prof.tick("qap")
    g1_pts = ec.scalar_mul_batch(
        ec.G1, bn254.G1_GEN, bi.to_tensor([s % r for s in g1_scalars], dev))
    g2_pts = ec.scalar_mul_batch(
        ec.G2, bn254.G2_GEN, bi.to_tensor([s % r for s in g2_scalars], dev))
    prof.tick("fixed-base batches")

    head1 = ec.affine_ints(ec.G1, g1_pts[:3])
    head2 = ec.affine_ints(ec.G2, g2_pts[:3])
    pos = 3
    a_query = g1_pts[pos : pos + n_vars]
    pos += n_vars
    b1_query = g1_pts[pos : pos + n_vars]
    pos += n_vars
    ic = ec.affine_ints(ec.G1, g1_pts[pos : pos + n_pub_total])
    pos += n_pub_total
    l_query = g1_pts[pos : pos + n_vars - n_pub_total]
    pos += n_vars - n_pub_total
    h_query = g1_pts[pos:]
    pk = ProvingKey(
        curve_name="bn128", n_public=n_publics, n_vars=n_vars,
        domain_size=m, alpha1=head1[0], beta1=head1[1], beta2=head2[0],
        delta1=head1[2], delta2=head2[2], a_query=a_query,
        b1_query=b1_query, b2_query=g2_pts[3:], l_query=l_query,
        h_query=h_query)
    vk = VerifyingKey(curve_name=pk.curve_name, alpha1=pk.alpha1,
                      beta2=pk.beta2, gamma2=head2[1], delta2=pk.delta2,
                      ic=ic)
    prof.done()
    return pk, vk


# The R1CS rows per constraint list: proving keys are reused across proofs,
# so the rows are walked once.  The stored list reference guards id() reuse.
_rows_cache: dict = {}


def _rows(constraints, device) -> r1cs.Rows:
    key = (id(constraints), device)
    ent = _rows_cache.get(key)
    if ent is None or ent[0] is not constraints:
        _rows_cache.clear()
        ent = _rows_cache[key] = (constraints, r1cs.build(constraints, device))
    return ent[1]


def _witness_h(constraints, wit: torch.Tensor, n_pub_total: int, m: int,
               prof: Prof) -> torch.Tensor:
    """Coefficients of H = (A*B - C)/Z via coset NTTs over F_r
    (groth16._witness_h): [m - 1, 4] standard words."""
    log_m = m.bit_length() - 1
    rows = _rows(constraints, wit.device)
    prof.tick("csr")
    wit_m = fr_ntt.to_mont(wit)
    abz = r1cs.evaluate(rows, wit_m, m, n_pub_total)  # one launch, [3, m, 4]
    prof.tick("r1cs eval")
    ac, bc, cc = (fr_ntt.to_coset(v, log_m) for v in abz)
    k = fr_ntt.mont_const(fr_ntt.z_coset_inv(m), wit.device)
    coeffs = fr_ntt.from_coset(fr_ntt.quotient(ac, bc, cc, k), log_m)
    prof.tick("ntts")
    if bool((coeffs[m - 1] != 0).any()):
        raise AssertionError("H degree overflow")
    return fr_ntt.from_mont(coeffs[: m - 1])


def _msm(g, points, scalars: torch.Tensor):
    return ec.affine_ints(g, ec.msm(g, points, scalars))[0]


def prove(pk: ProvingKey, constraints, witness, rng=None,
          prof: Prof | None = None) -> tuple[Proof, list]:
    """bellman create_random_proof equivalent (groth16.prove); returns
    (proof, publics).  Runs on the device of the key's queries."""
    c = bn254
    r = R
    dev = pk.a_query.device
    prof = prof or Prof("groth16.prove", dev)
    rand = rng or (lambda: secrets.randbelow(r))
    rr, ss = rand(), rand()
    witness = [int(x) % r for x in witness]
    n_pub_total = pk.n_public + 1
    wit = bi.to_tensor(witness, dev)
    prof.tick("witness")
    h = _witness_h(constraints, wit, n_pub_total, pk.domain_size, prof)
    prof.tick("witness_h")

    g1 = c.g1_from_affine
    a_acc = _msm(ec.G1, pk.a_query, wit)
    prof.tick("msm A")
    A = c.g1_add(c.g1_add(g1(a_acc), g1(pk.alpha1)),
                 c.g1_mul(g1(pk.delta1), rr))
    b2_acc = _msm(ec.G2, pk.b2_query, wit)
    prof.tick("msm B2 (G2)")
    g2 = c.g2_from_affine
    B = c.g2_add(c.g2_add(g2(b2_acc), g2(pk.beta2)),
                 c.g2_mul(g2(pk.delta2), ss))
    b1_acc = _msm(ec.G1, pk.b1_query, wit)
    prof.tick("msm B1")
    B1 = c.g1_add(c.g1_add(g1(b1_acc), g1(pk.beta1)),
                  c.g1_mul(g1(pk.delta1), ss))
    l_acc = _msm(ec.G1, pk.l_query, wit[n_pub_total:])
    prof.tick("msm L")
    h_acc = _msm(ec.G1, pk.h_query, h)
    prof.tick("msm H")
    C = c.g1_add(g1(l_acc), g1(h_acc))
    C = c.g1_add(C, c.g1_mul(A, ss))
    C = c.g1_add(C, c.g1_mul(B1, rr))
    C = c.g1_add(C, c.g1_neg(c.g1_mul(g1(pk.delta1), rr * ss % r)))

    proof = Proof(a=c.g1_to_affine(A), b=c.g2_to_affine(B),
                  c=c.g1_to_affine(C))
    prof.done()
    return proof, witness[1:n_pub_total]


def verify(vk: VerifyingKey, proof: Proof, publics) -> bool:
    """e(A, B) == e(alpha, beta) * e(IC(pub), gamma) * e(C, delta)."""
    c = bn254
    r = R
    publics = [int(x) % r for x in publics]
    if len(publics) + 1 != len(vk.ic):
        return False
    acc = c.g1_from_affine(vk.ic[0])
    for w, pt in zip(publics, vk.ic[1:]):
        acc = c.g1_add(acc, c.g1_mul(c.g1_from_affine(pt), w))
    ic = c.g1_to_affine(acc)
    neg = lambda p: (p[0], (-p[1]) % c.P) if p else None  # noqa: E731
    return c.multi_pairing([
        (proof.a, proof.b),
        (neg(vk.alpha1), vk.beta2),
        (neg(ic), vk.gamma2),
        (neg(proof.c), vk.delta2),
    ])
