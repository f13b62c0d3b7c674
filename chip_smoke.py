#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (eigen_zkvm_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, each of which fails the run (non-zero exit, no result line):
  1. probe    a CUDA device must be present; prints the card's name and
              power limit as nvidia-smi reports them.
  2. build    compiles eigen_zkvm_tpu_torch/csrc/*.cu with nvcc (sm_90a),
              one job a source, all started together; prints each job's
              seconds and ptxas report, slowest first.
  3. kernels  the device field primitives (csrc/gl.cuh) against Python
              integers on every ordered pair of their edge operands and 2^20
              random pairs; then each kernel against its plain PyTorch
              version on the card at the main path's shapes, bit for bit
              (tolerance 0: finite-field integer arithmetic), edge states and
              all-zero / all-(p-1) columns mixed into the random inputs, with
              both times from CUDA events.  The measured IMAD.WIDE.U32 issue
              rate is printed beside the one the bounds assume.
              Then the BN254 field primitives (csrc/bn254.cuh: Fq, Fr and Fq2
              add, sub, mul, sqr, inv) against Python ints on their edge
              operands (0, 1, q - 1, q - 2, R mod q) and 2^20 random pairs
              (2^16 for the Fq2 ones), and three Groth16 kernels against
              their plain versions, exactly: the MSM (csrc/msm.cu, against
              ec_jax's double-and-add in ops/ec.msm_plain) in G1 and G2 at
              n = 2^16 with infinity points, a duplicated point,
              scalars 0, 1 and r - 1, a hot bucket and signed digits at
              +-2^(c-1) with carries; the fixed-base batch
              (csrc/ec_batch.cu) at 2^16 lanes in G1 and G2; the Fr NTT
              (csrc/fr_ntt.cu, two or three passes a transform) forward and
              inverse at 2^22 (phase 11's domain), 2^18 and 2^16 against
              the radix-2 ladder of ntt_plain, and at 2^22 the coset round
              trip (to_coset, from_coset: the scales ride on the inverse
              transforms' last passes) and its pointwise products (by a
              constant, the quotient).
  4. prove    the chain AIR of scripts/bench_big.py at 2^20 rows x 8 columns
              (blowup 2, 8 queries), written to files and proved through the
              port's file-based stark_prove on the card, device-resident
              (commits, constraint VM, Q split, openings, FRI folds), which
              verifies its proof: stage split, peak device memory, kernel
              launch counts.  The proof JSON's sha256 must equal
              HOST_PROOF_SHA256, the digest of eigen_zkvm_tpu's host-engine
              proof of the same files.  No module of JAX or of the JAX
              package (eigen_zkvm_tpu) may have been loaded.
  5. groth16  bench_groth16's synthetic BN254 R1CS of 2^18 - 3 constraints
              and 2 publics (domain 2^18, about 2^18 wires, half of them
              boolean) through groth16_setup_inplace, groth16_prove_inplace
              and groth16_verify_inplace on the card: the verifier accepts,
              and the proof JSON's sha256 must equal GROTH16_HOST_SHA256,
              the digest of eigen_zkvm_tpu's host-engine proof of the same
              circuit with the same draws.  (Phase 11 holds the kernels at
              the wrap's full-size shapes.)
  6. cli      the port's command line (eigen_zkvm_tpu_torch/cli.py) on a
              synthetic circuit of its own (2^16 - 3 constraints, setup
              from the same seed): the circuit written as a .r1cs file,
              its witness as a .wtns file, its seeded key as the port's
              key file; groth16_prove (its proof draws r and s from
              `secrets`, so groth16_verify's OK holds it, not a digest),
              groth16_verify and generate_verifier (the JAX package's
              text) through cli.main on the card, each one's seconds and
              the file loads'; groth16_setup, prove and verify of a
              two-constraint circuit through the CLI.
  7. args     the example AIRs with plookup, permutation and connection
              arguments (eigen_zkvm_tpu_torch/examples/) at 2^5 and 2^16
              rows, written to files and proved and verified through the
              CLI's stark_prove and stark_verify on the card; each zkin's
              sha256 must equal ARG_SHA256, the host engine's digest.
  8. zkvm     zkVM chunk proving through eigen_zkvm_tpu_torch/zkvm/: the
              native RV32 executor built with g++, the in-guest secp256k1
              ecrecover (data/guests/ecrecover.elf.gz, built by the port's
              C compiler zkvm/cc.py, which tests/test_torch_rv32.py holds)
              loaded and run to its
              end in 2^16-row continuation chunks (239, 15,642,943
              cycles), the RV32IM machine (375 committed, 179 constant
              columns, 99 plookups) set up once on the card, then chunks 0
              and 1 traced, proved on the card (default_struct(16, 4)) and
              verified; each chunk's RAM-image digest publics equal
              ram_digest of its images, the two chain, and each zkin's
              sha256 must equal ZKVM_SHA256, the host engine's digest.
              Chunk 0's stark_gen runs beside nvidia-smi's utilization
              samples (its busy share and device time); both chunks' zkins
              stay for phase 10.  Then the MiniRV machine's MEMWALK guest
              over two 2^10-row chunks with a 64-word RAM image
              through zkvm_execute_and_prove on the card.
              The NTT and Poseidon kernels are held at this path's widths:
              the LDE [2^16, 375] -> [2^17, 375] and the leaves of
              [2^17, 375] (the plain version on one row in 8).
  9. bigfield big-field eSTARK proves through the CLI's stark_prove on the
              card, at the shape of the reference's final BN128 layer
              (2^16 -> 2^17 rows, 8 queries, FRI steps 17, 13, 9, 5): the
              12-column chain AIR with BN128 and with BLS12381, and the
              permutation example with BN128 (a committed stage-3 section
              under the big field).  Every Merkle tree hashes on the
              Poseidon-over-Fr kernel (csrc/poseidon_fr.cu), whose count
              must rise in each prove; each zkin's sha256 must equal
              BIGFIELD_SHA256, the host engine's digest.  Then the kernel
              against its plain version at the proves' shapes, each on the
              group size ops/poseidon_fr.plan picks: the 2^17 t = 5 leaf
              permutations, a 2^13-node t = 17 level (BN128 and
              BLS12381), the 2^9-node and the 1-node t = 17 levels (the
              latency cases), 2^14 rows of width 375 (t = 17 and t = 14 in
              one sponge), 0 and r - 1 mixed in; then every width
              t = 2..17 of both fields at 1,001 states on every group size
              the width allows and on plan's pick (every instance of the
              kernel), exactly (the plain version on 81 of the rows,
              copied to the CPU, where it runs on Python ints: its 32
              calls on the card, launch-bound, took 19.7 s);
              then the leaves' and each level's time in one BN128 tree
              over 2^17 rows of width 12 and of width 0
              (bench_poseidon_fr.tree_split).
 10. recursion the GL recursion layers (eigen_zkvm_tpu_torch/recursion/) over
              phase 8's two chunk zkins, taken from memory, on the card
              (bench_recursion.run_layers, scripts/zkvm_e2e.py:135-170): c12
              of each chunk (skip_main, natural size), recursive1 of each
              (forced to 2^RECURSION_FORCE rows), and the chained
              aggregation of the two (ChainMap.for_machine: chunk 0's
              out-state is chunk 1's in-state inside the circuit), all at
              RECURSION_QUERIES queries, each self-verified on the host.
              Each of the five zkins' sha256 must equal RECURSION_SHA256,
              the host engine's digest; the aggregated proof's mem_in*
              must equal chunk 0's image digest and its mem_out* chunk
              1's outgoing one.  Then the NTT and Poseidon at recursive1's
              shapes: the LDE of each of its sections (committed,
              constant, stage 3, Q) from 2^18 to 2^19 rows and their
              leaves (the plain version on one row in 8).
 11. wrap     the final BN128 layer and the Groth16 wrap of phase 10's
              aggregated proof, taken from memory (bench_e2e, scripts/
              zkvm_e2e.py:177-220): the aggregation's verifier circuit with
              the constant root as an input (compressor12, verkey_input),
              proved on the card under the BN128 transcript and 16-ary
              Poseidon-over-Fr trees (bench_e2e.final_struct) and verified;
              then the BN254 circuit that verifies that proof
              (build_final_main, WRAP_CONSTRAINTS constraints, domain
              2^22), its check(), a Groth16 setup (bench_groth16.seeded(
              bench_e2e.G16_SEED)), prove (seeded(G16_SEED + 1)) and verify
              on the card, and the verify of a changed public, which must fail.
              The one public must be sha256(proverAddr || publics) mod r;
              the final zkin, the circuit's .r1cs and .wtns bytes, the
              proof JSON and the Solidity verifier rendered from the vk
              must equal WRAP_SHA256, the host engine's digests.  Then the
              kernels at the wrap's shapes: the NTT at the LDE of each of
              the final layer's sections, Poseidon-Fr at their leaves and
              at the first tree level (the plain version on one row in
              16); the MSM on the prove's own inputs (the A query in G1
              and the B2 query in G2, with the witness) against the plain
              versions of its stages (ops/ec.msm_stages_plain); the
              fixed-base batch at setup's lane counts (G2 checked on one
              lane in 8, G1 on one in 32); the R1CS rows (csrc/r1cs.cu: the
              three matrices in one launch, padded, the publics in A's
              tail) of the circuit, then of bench_groth16.long_rows at 2^16
              rows (rows of 0 to 4,096 nonzeros, a warp for each long
              one); the Fr NTT's coset transform of A's evaluations.  These
              cases are the ones the kernels' line reports for the four
              Groth16 kernels and Poseidon-Fr.
 12. circom   the circom surface (bench_circom): the verifiers of phase
              10's c12 and recursive1 of chunk 0 and its aggregation and of
              phase 11's final BN128 layer, kept from memory
              (bench_circom.layer_keeper) and rendered as circom text
              (stark/pil2circom.py; the on-chain render for the final
              layer) with the options the next layer's setup gets
              (bench_circom.LAYER_OPTIONS); GLMulChain(1000)
              (data/circuits/glmul_chain.circom: 1,000 chained Goldilocks
              products emulated over BN254's Fr with inline 64-bit range
              checks) compiled over Fr at -O2 (129,000 constraints, 2
              publics), its .r1cs, .wtns and .sym written, then a Groth16
              setup (seeded(bench_circom.G16_SEED)), prove (seeded(G16_SEED
              + 1)) and verify on the card and the verify of a changed
              public, which must fail; GLSquareChain(1100) compiled over
              Goldilocks, packed into the compressor PIL (2^16 rows),
              written to files and proved through the file-based
              stark_prove on the card, which renders its verifier (and the
              skip_main render beside it).  Every render, the three files,
              the proof JSON and the zkin must equal CIRCOM_SHA256, the
              JAX package's bytes.  Then K4 on GLMulChain's rows (65
              nonzeros with power-of-two coefficients, a warp each)
              against its plain version, exactly.
 13. guests   the zkVM guests (zkvm/{evm,guests_llvm,guest_evm_c}.py): each
              committed guest ELF run to its end on phase 8's native
              executor, its a0 against its oracle: the three LLVM-built
              guests (data/llvm_guests/, guests_llvm.*_expected()) and the
              EVM interpreter guest on the token contract
              (data/guests/evm_token.elf.gz, guest_evm_c.TOKEN_A0, word 0
              of evm_mirror's post-state digest); then the EIP-1559 value
              transfer (data/guests/transfer_state.json, a made-up state
              test in the reference's format) proved on the card through
              evm.prove_state_test at 2^11 rows, 512 rows a chunk: one
              RV32IM setup, two chunks proved, verified and chained; the
              last chunk's mem_out* equal to the digest of the post-state
              image, whose accounts equal the file's postState (both held
              by prove_state_test); each chunk's zkin sha256 equal to
              GUESTS_SHA256, the host engine's digest.  Setup and each
              chunk's stages are printed.  Then the NTT at the LDE of the
              machine's committed section, [2^11, 375] -> [2^12, 375], and
              Poseidon at its leaves, every row, against their plain
              versions.
              These guests are built on the CPU by the port's toolchains
              (zkvm/cc.py on pycparser, zkvm/llvm_backend.py on
              libLLVM-15), which this script never imports: it proves
              committed or hand-assembled guests only.
 14. bls      BLS12-381 Groth16, the SNARK of the reference's simple_bls.sh:
              BLS12-381's Fq and its Fq2 (csrc/bn254.cuh row 3, 12 limbs)
              against Python ints on their edge operands and 2^20 random
              pairs (2^16 for Fq2); bench_groth16's synthetic circuit over
              BLS12-381's r at phase 5's shape (2^18 - 3 constraints, 2
              publics, domain 2^18, the same seeds) through
              groth16_setup_inplace, groth16_prove_inplace and
              groth16_verify_inplace("bls12381", ...) on the card: the
              verifier accepts, a changed public is rejected, the BLS
              instances of the four kernels launch, and the proof JSON's
              sha256 must equal BLS_GROTH16_HOST_SHA256, the host engine's
              digest.  Then, after the counts are read, the four kernels
              at BLS12-381 against their plain versions, exactly: K1 on
              the prove's own A (G1) and B2 (G2) inputs against
              ec.msm_stages_plain and at 2^13 points with phase 3's edge
              cases (bit 254 set added) against the double-and-add (cut
              from 2^16: launch-bound, 255 rounds whatever n); K2 at
              setup's lane counts (G2 on one lane in 8, G1 on one in 32);
              K3 forward, inverse, the coset round trip, the product by a
              constant and the quotient at 2^18; K4 on the prove's rows.
              These cases are the ones the kernels' line reports for the
              BLS12-381 kernels.
 15. bridge   the gnark bridge (recursion/gnark_bridge.py: a BN254 Groth16
              proof verified inside a BLS12-381 circuit) at the part the
              smoke has room for: bench_bridge.toy_inner's BN254 proof
              (seeded draws, on the card), then bench_bridge.bridge_part
              of it (build_verifier_circuit's calls up to the residue
              check's c * c^-1 = 1, without B's on-curve and subgroup
              checks and the Miller loop: BRIDGE_PART_CONSTRAINTS
              constraints, domain 2^19) through groth16_setup_inplace,
              groth16_prove_inplace and groth16_verify_inplace("bls12381",
              ...) on the card: the BLS12-381 kernels launch, the verifier
              accepts, a changed public is rejected, and the proof JSON's
              sha256 must equal BRIDGE_PART_SHA256, the host engine's
              digest of the same composition built from the JAX package's
              modules.  Then K3 at the full bridge's domain, 2^23 (three
              passes of fr_ntt_pass), forward, inverse and the coset round
              trip against ntt_plain, exactly.  The full bridge (about
              7.84 M constraints) is bench_bridge's.
 16. sharded  the multi-rank prover (eigen_zkvm_tpu_torch/parallel/): first
              the NTT and Poseidon at a rank's local shapes (a pol block's
              LDE [2^20, 2] -> [2^21, 2], a row block's leaves [2^19, 8],
              the first level of its subtree, the top fold over the four
              sub-roots) against their plain versions, exactly; then
              four ranks spawned on this card over gloo (every collective
              staged through host buffers; the kernels built in phase 2)
              prove phase 4's files through sharded_prove: each rank's
              proof JSON sha256 must be HOST_PROOF_SHA256, rank 0's proof
              must verify, and both GL kernels must launch on every rank;
              then make_sharded_commit on a (2, 2) grid over two seeded
              2^20 x 8 traces, its roots equal to the single-device
              extend_and_merkelize roots.  Prints the phase's seconds, the
              stage walls, the collectives' calls, seconds and bytes, and
              each rank's peak device memory.

Phase 3 holds each kernel at every shape the main path gives it: the NTT
at the LDE of a section, a leaf tile, the Q split's iNTT and NTT and the
FRI fold's group iNTT; Poseidon at a Merkle level, a bare permutation and
a fold tree's 96-wide leaves (the sponge calls that chain a capacity).
Each path's kernels must launch in its own run (counts set to 0 just
before it, read just after): the GL kernels in phase 4, the four Groth16
kernels in phase 5, K1, K3 and K4 in phase 6's prove, the GL kernels in
each of phase 7's proves and of phase 8's chunk and MEMWALK proves, the
NTT and Poseidon-Fr in each of phase 9's proves, the NTT and Poseidon in
each of phase 10's five layers, the NTT and Poseidon-Fr in phase 11's
final layer, K2 in its Groth16 setup and K1, K3 and K4 in its prove, K2
in phase 12's Groth16 setup, K1, K3 and K4 in its prove and the NTT and
Poseidon in its compressor prove, the NTT and Poseidon in phase 13's
transfer prove, the BLS12-381 kernels in phase 14's setup and prove and
in phase 15's, the GL kernels on every rank of phase 16.
The kernels' line gives the GL kernels phase 4's launches, Poseidon-Fr
phase 9's and 11's final layer's, the Groth16 kernels phase 11's wrap's,
the BLS12-381 instances phase 14's.

Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and the IMADs its function needs at the least
over the card's peak IMAD rate (constants below).  The IMADs are counted
from the function and this run's data, not from the kernel: its field
products (butterflies and scales of a radix-2 transform, the S-boxes and
linear layers of the Poseidon opt schedule), each priced at the fewest
32-bit multiply-adds the ISA allows for it.  A BN254 product is priced at
2 * 8^2 = 128 (the 8x8 limb products of a*b and of the Montgomery
reduction), and so is one over BLS12-381's r (8 limbs too); one over
BLS12-381's Fq at 2 * 12^2 = 288; a mixed addition at 11 products (7M +
4S; 33 Fq products in G2).  An MSM needs, at the least over c, one mixed addition for each
nonzero c-bit digit of a finite point's scalar and 2^(c+1) a window for
the bucket reduction; a fixed-base lane one for each nonzero 8-bit digit
after its first, and 7 products for its affine result; a transform
(m/2) log2 m products; the R1CS one product a nonzero whose coefficient
is not +-1, with 4 bytes a row offset and a wire and 2 or 4 a coefficient
index; a big-field Poseidon permutation of width t 8 (3t + t^2) products
in its full rounds and n_p (2t + 2) in its partial rounds (the field
product priced as BN254's, 128).  No single PyTorch call computes a
Goldilocks NTT, a Poseidon permutation, an MSM or an Fr NTT over these
fields, so `library_ms` is null.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

NBITS, WIDTH, QUERIES = 20, 8, 8
# phase 5's synthetic circuit (domain 2^18) and phase 6's (domain 2^16)
G16_CONSTRAINTS, CLI_CONSTRAINTS, G16_SEED = (1 << 18) - 3, (1 << 16) - 3, 1
# phase 3's shapes: the MSM's and fixed-base batch's edge cases, the Fr
# transforms (the 2^22 domain of phase 11's wrap first, then phase 5's and
# phase 6's domains)
G16_CHECK_N, G16_CHECK_NTT_BITS = 1 << 16, (22, 18, 16)
# sha256 of the proof JSON that eigen_zkvm_tpu's host engine writes for this
# chain AIR (its file-based stark_prove, from the files that
# bench_chain.write_chain_files writes).  The CUDA test
# tests/test_torch_prove.py::test_port_on_the_card_matches_host_engine_at_smoke_size
# proves both engines at this size and holds both to this digest.
HOST_PROOF_SHA256 = \
    "7d6bf093c6afc7d4f4467d3fbc27701343f67b291fab11508b7519964610390b"
# sha256 of the proof JSON that eigen_zkvm_tpu's host engine (its native
# C++ path) writes for bench_groth16.synthetic(G16_CONSTRAINTS, 2, G16_SEED)
# with setup drawing from bench_groth16.seeded(G16_SEED) and prove from
# seeded(G16_SEED + 1).  The CUDA test
# tests/test_torch_groth16.py::test_port_on_the_card_and_host_engine_match_the_pinned_digest
# proves both packages at this size and holds both to this digest.
GROTH16_HOST_SHA256 = \
    "7ee8408ad840cb508302dbc451e38e859e9ad789ee16714e11635e9f61b86074"
# Phase 7: the example AIRs with plookup, permutation and connection
# arguments (eigen_zkvm_tpu_torch/examples/), at the CPU tests' 2^5 rows and
# at 2^16, with bench_chain.chain_struct_json(nbits, ARG_QUERIES).  The
# digests are the zkin JSON's sha256 that eigen_zkvm_tpu's host engine
# (EIGEN_ZKVM_ENGINE=host, its in-memory StarkSetup and stark_gen) writes
# for the JAX package's examples/ AIRs of the same sizes and struct;
# tests/test_torch_cli.py proves the 2^5 ones through the port on the CPU.
ARG_AIRS, ARG_NBITS, ARG_QUERIES = ("plookup", "permutation",
                                    "connection"), (5, 16), 8
ARG_SHA256 = {
    ("plookup", 5):
        "0a5b6c76510edec99b2972af096099d4bba190a7f9d2b7f58101c9913bbec8b1",
    ("permutation", 5):
        "7daab5b65d81b033544cb05eeb85211499515cfa36c3d8bf8989ba286225455c",
    ("connection", 5):
        "b39257935f24931da7aad8d4c9ea55691aac36b5ad0cc4126510104175cc864f",
    ("plookup", 16):
        "2202d7c19c7554a1193ec026aed1d93ca637c413b74f34c6fa4cadc868b8ea96",
    ("permutation", 16):
        "7e918c37e8aeeb162c249a07fbe680624ac0b0bc96411f647ad84a5400b8fc8a",
    ("connection", 16):
        "e241e92b373ff978ad24d7765151e5c370cf899ac4940f6c2ed72db3ec4eb297",
}
# Phase 8: the ecrecover guest's chunks proved on the card, at
# bench_zkvm.NBITS rows and bench_zkvm.QUERIES queries.  The digests are the
# zkin JSON's sha256 that eigen_zkvm_tpu's host engine writes for the same
# chunks (its Rv32Machine, StarkSetup and stark_gen on the JAX package's
# native chunker's states);
# tests/test_torch_rv32.py::test_host_engine_gives_the_pinned_zkvm_digests
# recomputes them.
ZKVM_CHUNKS = (0, 1)
ZKVM_SHA256 = {
    0: "5214d71fcd7ca054407b707947c8435b161f0e63e5a06a945e7312ee5a7a92c5",
    1: "5dc0fb980bb1ab8fe441ff162224ae2eb4f64318237d68fe2c63ace370cd294f",
}
ZKVM_WIDTH = 375   # the RV32IM machine's committed columns for this guest
# tests/test_zkvm_continuations.py's MiniRV guest: writes i into M[i mod
# slots] for i = 1..n, then sums the slots; 2^10-row chunks, 64 image words
MEMWALK = """
    in x1
    li x2, 0
    in x3
    li x4, 0
loop:
    blt x2, x1, body
    j sum
body:
    addi x2, x2, 1
    blt x4, x3, nowrap
    li x4, 0
nowrap:
    sw x2, x4, 0
    addi x4, x4, 1
    j loop
sum:
    li x5, 0
    li x6, 0
rd:
    blt x6, x3, rl
    j done
rl:
    lw x7, x6, 0
    add x5, x5, x7
    addi x6, x6, 1
    j rd
done:
    halt
"""
MEMWALK_TAPE, MEMWALK_NBITS, MEMWALK_RAM = [280, 48], 10, 64
# Phase 9: big-field eSTARK proves at the reference final layer's shape
# (scripts/zkvm_e2e.py:183-188: nBits + 1, then down by 4 while above 5),
# the struct bench_chain.chain_struct_json(16, 8, hash, "final").  The
# digests are the zkin JSON's sha256 that eigen_zkvm_tpu's host engine (its
# in-memory StarkSetup and stark_gen) writes for the same AIR and struct;
# tests/test_torch_prove_bigfield.py::test_host_engine_gives_the_pinned_bigfield_digests
# recomputes them.
BIGFIELD_NBITS, BIGFIELD_QUERIES, BIGFIELD_WIDTH = 16, 8, 12
# Poseidon-Fr's every-width check: a batch that is no multiple of a group
# (1-32 threads) or a block (32-128), and the rows the plain version
# computes: the three edge states, one row in 16, and the last 17 (the
# last group, warp and block)
FR_EVERY_B = 1001
FR_EVERY_ROWS = sorted({0, 1, 2, *range(0, FR_EVERY_B, 16),
                        *range(FR_EVERY_B - 17, FR_EVERY_B)})
BIGFIELD_SHA256 = {
    ("chain", "BN128"):
        "581f2c11d3ff07b0f6a474922eef87110103dafed9ef2f5a5b224277c18f7aa6",
    ("chain", "BLS12381"):
        "c6cb3604e774629bbb35d134d1732f5071b06bce44da4860cabc140250b0fe0a",
    ("permutation", "BN128"):
        "de29d770cb45559c67fa0b6e8637f57a13201d2c499ce925706361019692dc58",
}
# Phase 10: the recursion layers over phase 8's chunks (scripts/zkvm_e2e.py:
# 135-170): c12 of each, recursive1 of each forced to 2^RECURSION_FORCE
# rows (recursive_proof_to_snark.sh:88), the chained aggregation of the
# two, every layer at RECURSION_QUERIES queries.  The digests are the zkin
# JSON's sha256 that eigen_zkvm_tpu's host engine writes for the same
# layers over its own proofs of the same chunks;
# tests/test_torch_recursion.py::test_host_engine_gives_the_pinned_recursion_digests
# recomputes them.
RECURSION_QUERIES, RECURSION_FORCE = 4, 18
RECURSION_SHA256 = {
    "c12 0":
        "08c8ea25e705859e86deab00a8b3574f35af5feeb1d1eb5f9c9973086d1fccb5",
    "recursive1 0":
        "2880942486900c272cd7dc8bf8a1f5c2de7a96a1ae558e4b70695c100e8bcbd4",
    "c12 1":
        "468865d80f5d37ec56d2e38c679067c1f0d5d963ebd41eced9ebad5dcdaf0c5b",
    "recursive1 1":
        "3f60ff89cc41845498b1c062bbf83474bfdaaa85252ccdcd8be5d69a078607d5",
    "aggregation":
        "e283c0ad056a1fa3fb8982c4cc6ee2eda0cf71ee743c9af86a3c843474ceb87f",
}
# Phase 11: the final BN128 layer of phase 10's aggregated proof and its
# Groth16 wrap (scripts/zkvm_e2e.py:177-220; bench_e2e.run_final_and_wrap),
# setup drawing from bench_groth16.seeded(bench_e2e.G16_SEED) and the prove
# from seeded(G16_SEED + 1).  The digests (bench_e2e.wrap_digests:
# the final zkin JSON, the circuit's .r1cs and .wtns bytes, the proof JSON,
# the Solidity verifier) and the constraint count are the JAX package's
# host engine's for the same chunks, layers and draws;
# tests/test_torch_wrap_cuda.py::test_host_engine_gives_the_pinned_wrap_digests
# recomputes them.
WRAP_CONSTRAINTS = 2_177_591
WRAP_SHA256 = {
    "final zkin":
        "dc9329d52150dd7473678a052a79cdb927da1e5f848be6e30237b9826f401fb6",
    "circuit":
        "cb6f6bcc5c37535f81c81f01dd150ae63855ca23d6ad2129e05367fac2487b81",
    "proof":
        "7c862dfd0983a4d1f2748be90d222bb351a8fbcf6014e59fdae511a067c0a2fd",
    "verifier.sol":
        "687ca5efd5a5111f973ff18e47e82053d82dac6f2d7a0b2d752db3a3f3aeaa27",
}
# Phase 12: the circom surface (bench_circom).  The sha256 of the verifiers
# of phase 10's c12 and recursive1 of chunk 0 and aggregation and phase
# 11's final layer, rendered as circom text (bench_circom.LAYER_OPTIONS);
# of GLMulChain(GLMUL_N)'s .r1cs, .wtns and .sym at -O2 and its Groth16
# proof JSON (draws from bench_groth16.seeded(bench_circom.G16_SEED) and
# seeded(G16_SEED + 1)); of GLSquareChain(GLSQUARE_N)'s compressor zkin
# and the two renders of its verifier.  They are the JAX package's (its
# compiler, simplify, Groth16 and stark_prove on its host engine, and its
# render of its own setups of the same layers): tests/test_torch_circom_
# cuda.py::test_host_engine_gives_the_pinned_{circuit_digests,
# layer_renders} recompute them.
CIRCOM_SHA256 = {
    "c12 0":
        "0641b70be19714828e1590b7555bd114a65077a39fc69b68c5bcf60e293f62e3",
    "recursive1 0":
        "dbabc1ad92687e752bd2690814ba933a293c7dd60223d6cfe78f9759f394aa8a",
    "aggregation":
        "26f16c974eefbf06a2001af4ca1119f1a7ea8b0e65224f1453e0399d56946998",
    "final":
        "ba2545e86e010ed7d1c45c295f4e6b00b8d7e4a5e5769da648724976b12a00a5",
    "glmul .r1cs":
        "6b7e156b1a2a1f64a18ea882dc01315feae2ca9ea8903ccc3a7b80f1618ac6af",
    "glmul .wtns":
        "9956e6e43a9045bc687480274fb0f6737b8731a851a314f39d9e2e8a5a1a235b",
    "glmul .sym":
        "2e067259f5d1ea357821d35babcadc5187f9f3b20aac78fb1ff53dbb04560e34",
    "glmul proof":
        "7e78fd0e7dc89868e3b206595b30f4b62da1fd426a2e1b3a4ff4b91e50803ae3",
    "glsquare zkin":
        "89dc51ef4deec677af8ea532295307dbb242977e2b87ce0ee3748be8c718cc75",
    "glsquare circom default":
        "ecaa174b83962f08be8611ea573832b5ef1f9c5badc5d2323f9066679e62eb30",
    "glsquare circom skip_main":
        "de6d765824c498eab124a344239be82272ba6f9cbcd27f5a7f925700eb812ca1",
}
# Phase 13: the zkVM guests.  The EVM value-transfer guest (zkvm/evm.py's
# TRANSFER_GUEST) on the committed state test data/guests/
# transfer_state.json, proved through evm.prove_state_test at
# 2^bench_guests.NBITS rows, bench_guests.BUDGET rows a chunk (two chunks),
# bench_guests.QUERIES queries.  The digests are the zkin JSON's sha256
# that eigen_zkvm_tpu's host engine writes for the same chunks (its
# prove_state_test on the same file);
# tests/test_torch_evm.py::test_host_engine_gives_the_pinned_guests_digests
# recomputes them.
GUESTS_SHA256 = (
    "28b1d4c9885674c07003e0e4a4d51984462d365227485093e0ac48de1443e9ae",
    "5c8a92b1d625c7b783e64e7ccb7450db2b4e809a4479f2346c3a7e796944f2de",
)
# Phase 14: BLS12-381 Groth16 (the SNARK of the reference's simple_bls.sh)
# on bench_groth16.synthetic over BLS12-381's r at phase 5's shape
# (G16_CONSTRAINTS rows, 2 publics, domain 2^18), setup drawing from
# seeded(G16_SEED), the prove from seeded(G16_SEED + 1).  The digest is the
# proof JSON's sha256 that eigen_zkvm_tpu's host engine (its native C++
# BLS12-381 path, native.ec_bls12381) writes for the same circuit and
# draws; tests/test_torch_groth16_bls.py::
# test_host_engine_gives_the_pinned_bls_digest recomputes it.
BLS_GROTH16_HOST_SHA256 = \
    "3cf996ffbaee9f47a9999f88bc5e4490a985fd37691c5afede669c36d6b67284"
# Phase 15: bench_bridge.bridge_part (the gnark bridge's calls up to the
# residue check's c * c^-1 = 1, without B's checks and the Miller loop) of
# bench_bridge.toy_inner's BN254 proof, BRIDGE_PART_CONSTRAINTS
# constraints over BLS12-381's r (domain 2^19), setup drawing from
# seeded(bench_bridge.OUTER_SEED), the prove from seeded(OUTER_SEED + 1).
# The digest is the proof JSON's sha256 that eigen_zkvm_tpu's host engine
# writes for the same composition built from the JAX package's modules;
# tests/test_torch_gnark_bridge.py::
# test_host_engine_gives_the_pinned_bridge_part_digest recomputes it.
BRIDGE_PART_CONSTRAINTS = 387_100
BRIDGE_PART_SHA256 = \
    "db73a58f797af4c1ad738695527bf50c295cb726ea5aa871a00f33dbbb595969"
# the Fr transforms held at the full bridge's domain: three passes
BRIDGE_NTT_BITS = 23
# K1's double-and-add holds in phase 14: launch-bound (255 rounds of
# batched point formulas whatever n), so n is cut to 2^13 points
BLS_CHECK_N = 1 << 13
LONG_ROWS = 1 << 16   # K4's long-row circuit (bench_groth16.long_rows)
# Phase 16: four gloo ranks on this card prove phase 4's files sharded,
# then run make_sharded_commit on a (2, 2) grid over COMMIT_BATCH seeded
# traces of phase 4's shape
SHARDS, COMMIT_GRID, COMMIT_BATCH, COMMIT_SEED = 4, (2, 2), 2, 16
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# Fewest IMADs (IMAD.WIDE.U32, a 32x32->64-bit multiply-add) for one
# Goldilocks product: a 64x64-bit product is four limb products, a square
# three (the cross product once, doubled by a shift), a product by a
# constant below 2^32 two.  Reducing mod p = 2^64 - 2^32 + 1 takes shifts
# and adds only.
IMAD_MUL, IMAD_SQR, IMAD_SMALL = 4, 3, 2
# Peak IMAD issue: 64 per clock on each of the 132 SMs (half the float32
# FMA lanes), at the 1.98 GHz at which the data sheet's 67 TFLOP/s float32
# holds.
IMAD_PER_S = 132 * 64 * 1.98e9
# One Poseidon-GL permutation in the opt schedule (hash/poseidon.py): 118
# x^7 S-boxes (12 lanes in each of 8 full rounds, one in each of 22 partial
# rounds; two squares and two products each), 7 MDS layers of 144 products
# by entries below 2^6, the dense pre-partial matrix (144 products) and 22
# sparse partial-round layers (12 + 11 products each).
POSEIDON_IMADS = (118 * (2 * IMAD_SQR + 2 * IMAD_MUL) + 7 * 144 * IMAD_SMALL
                  + (144 + 22 * 23) * IMAD_MUL)
# Fewest IMADs for one BN254 Montgomery product (Fq or Fr): 8x8 limb
# products for a*b and 8x8 for the reduction's m*q; BLS12-381's r is 8
# limbs too, its Fq 12: 12x12 and 12x12
IMAD_BN254 = 2 * 8 * 8
IMAD_BLS_FQ = 2 * 12 * 12
MADD_PRODUCTS = 11   # madd-2007-bl: 7M + 4S


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up (tables, first launch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ntt_imads(log_n: int, cols: int, scaled: bool) -> int:
    """IMADs of a radix-2 transform of 2^log_n rows x cols: n/2 log n
    butterfly products a column, and one more a value when the output is
    scaled (n^-1, the coset)."""
    n = 1 << log_n
    return cols * (n // 2 * log_n + (n if scaled else 0)) * IMAD_MUL


def _bound(nbytes: float, imads: float) -> dict:
    """The least time for the work: bytes over the memory rate, or IMADs
    over the IMAD rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def _max_abs_err(got, want) -> float:
    import torch

    if torch.equal(got, want):
        return 0.0
    diff = got.double() - want.double()  # only reached on a mismatch
    return float(diff.abs().max())


def _timed_once(fn):
    """One call of fn and its time from CUDA events (for plain versions that
    take seconds: no warm-up run)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _hold(label: str, kernel, plain, reps: int, plain_reps: int,
          nbytes: float, imads: float, rows=None) -> dict:
    """One shape of a kernel: its result against the plain version's on
    the same inputs, both times, its bound.  plain_reps = 0 times the one
    plain call that gives the result.  With `rows`, the plain version
    computes those rows of the kernel's result only (lanes that do not
    interact), and its time is for them."""
    got = kernel()
    if rows is not None:
        got = got[rows]
    if plain_reps:
        want = plain()
        plain_ms = _time_ms(plain, plain_reps)
    else:
        want, plain_ms = _timed_once(plain)
    err = _max_abs_err(got, want)
    del got, want
    ms = _time_ms(kernel, reps)
    b = _bound(nbytes, imads)
    print(f"{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
          f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), "
          f"max_abs_err {err}", flush=True)
    return dict(label=label, err=err, ms=ms, plain_ms=plain_ms, **b)


LEAF_BITS = 8   # the leaf tile held in phase 3: [2^8, 2^16]


def _edge_states(np):
    """Poseidon states at the field's edges: all zero, all p-1, alternating,
    all 2^32-1 (the edge states of tests/test_torch_poseidon.py)."""
    from eigen_zkvm_tpu_torch.ops import gl

    st = np.zeros((4, 12), dtype=np.uint64)
    st[1, :] = gl.P_INT - 1
    st[2, ::2] = gl.P_INT - 1
    st[3, :] = 0xFFFFFFFF
    return st


def _rand(rng, dev, shape, edge_rows=None):
    """Random field elements on `dev`; a 2-D shape gets an all-zero first
    and an all-(p-1) second column (NTT inputs), or, with `edge_rows`,
    those rows first (Poseidon inputs)."""
    import numpy as np

    from eigen_zkvm_tpu_torch.ops import gl

    a = rng.integers(0, 2**64, size=shape, dtype=np.uint64) \
        % np.uint64(gl.P_INT)
    if edge_rows is not None:
        a[: edge_rows.shape[0]] = edge_rows
    elif len(shape) == 2 and shape[1] >= 2:
        a[:, 0] = 0
        a[:, 1] = gl.P_INT - 1
    return gl.from_u64(a, dev)


def _leaf_perms(width: int) -> int:
    """Permutations of ops/poseidon.hash_leaves for one row of `width`:
    chunks of max(8, ceil(w/4)) columns, each a sponge of ceil(chunk/8)
    calls (none for 4 columns or fewer), then one sponge over the chunks'
    digests."""
    def sponge(w):
        return 0 if w <= 4 else -(-w // 8)

    if width <= 4:
        return 0
    bs = max(8, -(-width // 4))
    chunks = [min(bs, width - c) for c in range(0, width, bs)]
    perms = sum(sponge(c) for c in chunks)
    return perms if len(chunks) == 1 else perms + sponge(4 * len(chunks))


def _check_kernels(dev, rng) -> dict:
    """Phase 3: each GL kernel against its plain version at the main path's
    shapes.  {kernel name: cases}; the first case of a kernel is the one its
    line reports, its error the largest over all its cases."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.ops import gl, ntt, poseidon
    import numpy as np

    edge = _edge_states(np)

    def rand(*shape, edge_rows=None):
        return _rand(rng, dev, shape, edge_rows)

    n, ext = 1 << NBITS, NBITS + 1
    # NTT: the LDE of a committed section, a leaf tile, the Q split's iNTT
    # and NTT over the extended domain (q_dim 3, q_deg 1), the first FRI
    # fold's group iNTT (2^5 rows, every group and coordinate as a column)
    x = rand(n, WIDTH)
    leaf_x = rand(1 << LEAF_BITS, 1 << 16)
    root = ntt._root(LEAF_BITS)
    q = rand(2 * n, 3)
    grp = rand(1 << 5, 3 << 16)
    ntt_cases = [
        _hold(f"ntt interpolate [2^{NBITS},{WIDTH}]->[2^{ext},{WIDTH}]",
              lambda: ntt.interpolate(x, NBITS, ext),
              lambda: ntt.interpolate_plain(x, NBITS, ext), 20, 3,
              8 * WIDTH * 3 * n,
              _ntt_imads(NBITS, WIDTH, True) + _ntt_imads(ext, WIDTH, False)),
        _hold(f"ntt leaf [2^{LEAF_BITS},2^16]",
              lambda: ntt._leaf(leaf_x, LEAF_BITS, root),
              lambda: ntt.leaf_plain(leaf_x, LEAF_BITS, root), 20, 3,
              8 * 2 * leaf_x.numel(), _ntt_imads(LEAF_BITS, 1 << 16, False)),
        _hold(f"ntt Q-split intt [2^{ext},3]", lambda: ntt.intt(q, ext),
              lambda: ntt.intt_plain(q, ext), 20, 2, 8 * 2 * q.numel(),
              _ntt_imads(ext, 3, True)),
        _hold(f"ntt Q-split ntt [2^{ext},3]", lambda: ntt.ntt(q, ext),
              lambda: ntt.ntt_plain(q, ext), 20, 2, 8 * 2 * q.numel(),
              _ntt_imads(ext, 3, False)),
        _hold("ntt fold group intt [2^5,3*2^16]", lambda: ntt.intt(grp, 5),
              lambda: ntt.intt_plain(grp, 5), 20, 3, 8 * 2 * grp.numel(),
              _ntt_imads(5, 3 << 16, True)),
    ]
    del x, leaf_x, q, grp

    # Poseidon: one Merkle level of 2^21 digests, a bare permutation at
    # B = 2^20, the first fold tree's [2^16, 96] leaves (four 24-wide
    # chunks of three sponge calls, then two over their digests)
    pairs = rand(n, 8, edge_rows=edge[:, :8])
    st = rand(n, 12, edge_rows=edge)
    leaves = rand(1 << 16, 96, edge_rows=np.tile(edge, (1, 8)))
    pos_cases = [
        _hold(f"poseidon merkle level 2^{ext} digests",
              lambda: poseidon.hash_n(pairs),
              lambda: poseidon.hash_n_plain(pairs), 20, 2,
              8 * (pairs.numel() + pairs.shape[0] * 4),
              POSEIDON_IMADS * pairs.shape[0]),
        _hold(f"poseidon permute B=2^{NBITS}", lambda: poseidon.permute(st),
              lambda: poseidon.permute_plain(st), 20, 2, 8 * 2 * st.numel(),
              POSEIDON_IMADS * st.shape[0]),
        _hold("poseidon fold-tree leaves [2^16,96]",
              lambda: poseidon.hash_leaves(leaves, 96),
              lambda: poseidon.hash_leaves_plain(leaves, 96), 20, 2,
              8 * (leaves.numel() + leaves.shape[0] * 4),
              POSEIDON_IMADS * 14 * leaves.shape[0]),
    ]
    return {kernels.NTT.name: ntt_cases, kernels.POSEIDON.name: pos_cases}


def _msm_products(points, scalars, g2: bool, nbits: int = 254) -> int:
    """Fq products of the least bucket-method MSM of these inputs: min over
    c of the mixed additions it needs, one for each nonzero c-bit digit of a
    finite point's scalar (the kernel's entries) and 2^(c+1) for each
    window's bucket reduction, at 11 products each (33 in G2); scalars of
    `nbits` bits (254 on BN254, 255 on BLS12-381)."""
    from eigen_zkvm_tpu_torch.ops import ec

    live = scalars[~(points.flatten(1) == 0).all(1)]
    adds = min(sum(int((ec.digits(part, c, -(-nbits // c)) != 0).sum())
                   for part in live.split(1 << 19))
               + -(-nbits // c) * (1 << (c + 1)) for c in range(1, 25))
    return adds * MADD_PRODUCTS * (3 if g2 else 1)


def _fixed_base_products(scalars, g2: bool) -> int:
    """Fq products of the least fixed-base multiply over 8-bit window
    tables: for a lane with a nonzero scalar, one mixed addition (11
    products) for each nonzero 8-bit digit after its first, and 7 for the
    affine result (3 a lane of a batch inversion, then x/Z^2 and y/Z^3);
    3 Fq products an Fq2 product in G2."""
    from eigen_zkvm_tpu_torch.ops import ec

    total = 0
    for part in scalars.split(1 << 20):
        nz = (ec.digits(part, 8) != 0).sum(1)
        total += int((nz - 1).clamp(min=0).sum()) * MADD_PRODUCTS \
            + int((nz > 0).sum()) * 7
    return total * (3 if g2 else 1)


def _random_scalars(dev, n: int, seed: int, r: int | None = None):
    """n scalars below 2^(r.bit_length() - 1) < r made on the card (r
    BN254's by default: below 2^253), with 0, 1, 2 and r - 1 first and
    every fourth of the rest 0 (the wires a query leaves out)."""
    import torch

    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.ops import bigint as bi

    r = r or bn254.R
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    S = torch.randint(-2**63, 2**63 - 1, (n, 4), dtype=torch.int64,
                      device=dev, generator=gen)
    S[:, 3] &= (1 << (r.bit_length() - 1 - 192)) - 1
    S[4::4] = 0
    S[:4] = bi.to_tensor([0, 1, 2, r - 1], dev)
    return S


def _check_groth16_kernels(dev, rng) -> dict:
    """Phase 3, second half: K1 and K2 at 2^16 with edge inputs (K1
    against ec_jax's double-and-add), K3 at the wrap's 2^22, at 2^18 and
    at 2^16; phase 11 holds K1, K2, K3 and K4 at the wrap's prove's and
    setup's own shapes.
    {kernel name: cases}."""
    import random

    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import ec, fr_ntt

    R = bn254.R
    prng = random.Random(int(rng.integers(1 << 30)))
    n = G16_CHECK_N

    def scalars(count):
        return [prng.randrange(R) for _ in range(count)]

    # K2 first: it also makes the MSM's points
    k2_cases, points = [], {}
    for g, label in ((ec.G1, "G1"), (ec.G2, "G2")):
        S = bi.to_tensor([0, 1, 2, R - 1] + scalars(n - 4), dev)
        gen = ec.generator(g)
        k2_cases.append(_hold(
            f"ec_batch {label} {n} lanes",
            lambda: ec.scalar_mul_batch(g, gen, S),
            lambda: ec.scalar_mul_batch_plain(g, gen, S), 3, 0,
            n * 32 + n * 64 * g.deg,
            _fixed_base_products(S, g.deg == 2) * IMAD_BN254))
        points[label] = ec.scalar_mul_batch(g, gen, bi.to_tensor(
            [prng.randrange(1, R) for _ in range(n)], dev))

    # K1 against ec_jax's double-and-add: infinity points, a duplicated
    # point, scalars 0, 1 and r - 1, a hot bucket (a quarter of the scalars
    # 1, a quarter 0), signed digits at +2^(c-1) in every window and at
    # 2^(c-1) + 1 (negative, with a carry into the next window)
    k1_cases = []
    c = ec.window_bits(n)
    half, W = 1 << (c - 1), ec.n_windows(c)
    for g, label in ((ec.G1, "G1"), (ec.G2, "G2")):
        pts = points[label].clone()
        pts[5] = 0
        pts[100:103] = 0
        pts[9] = pts[8]
        ks = scalars(n)
        ks[0], ks[1], ks[2] = 0, 1, R - 1
        ks[3] = sum(half << (c * w) for w in range(W - 1)) % (1 << 253)
        ks[4] = sum((half + 1) << (c * w) for w in range(W - 1)) % (1 << 253)
        ks[6] = (1 << 253) | (1 << 252)
        for i in range(10, n // 2):
            ks[i] = i & 1
        S = bi.to_tensor(ks, dev)
        k1_cases.append(_hold(
            f"msm {label} n={n} (double-and-add)", lambda: ec.msm(g, pts, S),
            lambda: ec.msm_plain(g, pts, S), 5, 0,
            n * (32 + 64 * g.deg) + 64 * g.deg,
            _msm_products(pts, S, g.deg == 2) * IMAD_BN254))

    # K3: the transforms at the wrap's 2^22, at phase 5's 2^18 and phase
    # 6's 2^16 (other splits); at 2^22 the coset round trip (the scales on
    # the inverse transforms' last passes), the Montgomery conversion's
    # product by a constant and the quotient
    k3_cases = []
    for log_n in G16_CHECK_NTT_BITS:
        m = 1 << log_n
        x = bi.mont_ints(bi.FR, scalars(m), dev)
        prods = (m // 2) * log_n * IMAD_BN254
        k3_cases.append(_hold(
            f"fr_ntt 2^{log_n}", lambda: fr_ntt.ntt(x, log_n),
            lambda: fr_ntt.ntt_plain(x, log_n), 10, 1, 64 * m, prods))
        k3_cases.append(_hold(
            f"fr_ntt inverse 2^{log_n}",
            lambda: fr_ntt.ntt(x, log_n, inverse=True),
            lambda: fr_ntt.ntt_plain(x, log_n, inverse=True), 10, 1,
            64 * m, prods))
        if log_n != G16_CHECK_NTT_BITS[0]:
            continue
        k = fr_ntt.mont_const(fr_ntt.z_coset_inv(m), dev)
        k3_cases += [
            _hold(f"fr coset round trip 2^{log_n} (to_coset, from_coset)",
                  lambda: fr_ntt.from_coset(fr_ntt.to_coset(x, log_n), log_n),
                  lambda: fr_ntt.from_coset_plain(
                      fr_ntt.to_coset_plain(x, log_n), log_n), 10, 1,
                  64 * m, 3 * prods + 2 * m * IMAD_BN254),
            _hold(f"fr mul 2^{log_n} by a constant",
                  lambda: fr_ntt.mul(x, k), lambda: fr_ntt.mul_plain(x, k),
                  10, 1, 2 * 32 * m, m * IMAD_BN254),
            _hold(f"fr quotient 2^{log_n}",
                  lambda: fr_ntt.quotient(x, x, x, k),
                  lambda: fr_ntt.quotient_plain(x, x, x, k), 10, 1,
                  4 * 32 * m, 2 * m * IMAD_BN254)]
    return {kernels.MSM.name: k1_cases, kernels.EC_BATCH.name: k2_cases,
            kernels.FR_NTT.name: k3_cases}


def _r1cs_work(rows, wit, m: int) -> tuple:
    """K4's bytes and IMADs: each row offset (4 bytes), wire (4) and
    coefficient index (2 or 4) read once, the coefficient table and the
    witness read once, the [3, m, 4] output written once; one Fr product
    for each nonzero whose coefficient is not +-1 (table entries 0 and 1
    are 1 and -1: an add or a subtract).  The kernel's own row order and
    places (`Rows.dest`) are not the function's and are not counted."""
    nbytes = (4 * rows.indptr.numel()
              + rows.nnz * (4 + rows.cidx.element_size())
              + 32 * (rows.coefs.shape[0] + wit.shape[0])
              + 3 * m * 32)
    products = int((rows.cidx >= 2).sum())
    return nbytes, products * IMAD_BN254


def _check_groth16_shapes(dev, circ, pk, prove_rows) -> dict:
    """Phase 11, after the wrap: K1 on the prove's own inputs (the A query
    in G1 and the B2 query in G2 with the witness) against the plain
    versions of its stages, K2 at setup's lane counts (the G2 batch on one
    lane in 8, the G1 batch on one in 32), K4 on the circuit's three
    matrices (`prove_rows`, the prove's r1cs.Rows of them).
    {kernel name: cases}; the first case of each is the one its line
    reports."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import ec, fr_ntt, r1cs

    wit = bi.to_tensor([int(v) % bn254.R for v in circ.w], dev)
    k1_cases = []
    for g, label, pts in ((ec.G1, "A", pk.a_query),
                          (ec.G2, "B2", pk.b2_query)):
        n = pts.shape[0]
        k1_cases.append(_hold(
            f"msm {g} {label} query, the prove's inputs: n={n}, "
            f"c={ec.window_bits(n)} (plain stages)",
            lambda: ec.msm(g, pts, wit),
            lambda: ec.msm_stages_plain(g, pts, wit), 3, 0,
            n * (32 + 64 * g.deg) + 64 * g.deg,
            _msm_products(pts, wit, g.deg == 2) * IMAD_BN254))
    del wit

    n1 = 3 + 2 * pk.n_vars + pk.l_query.shape[0] + pk.n_public + 1 \
        + pk.h_query.shape[0]
    n2 = 3 + pk.n_vars
    k2_cases = []
    for g, n, step in ((ec.G2, n2, 8), (ec.G1, n1, 32)):
        S = _random_scalars(dev, n, n)
        gen = ec.generator(g)
        rows = None if step == 1 else slice(0, n, step)
        k2_cases.append(_hold(
            f"ec_batch {g} {n} lanes (setup's count)"
            + ("" if rows is None else f", plain on one lane in {step}"),
            lambda: ec.scalar_mul_batch(g, gen, S),
            lambda: ec.scalar_mul_batch_plain(
                g, gen, S if rows is None else S[rows]), 2, 0,
            n * 32 + n * 64 * g.deg,
            _fixed_base_products(S, g.deg == 2) * IMAD_BN254, rows=rows))
        del S

    # K4: the prove's one launch over the three matrices, then the
    # long-row circuit (rows of 0 to 4,096 nonzeros: warps beside threads)
    from eigen_zkvm_tpu_torch import bench_groth16

    k4_cases = []
    long = bench_groth16.long_rows(LONG_ROWS, G16_SEED)
    for label, c, m, n_pub in (
            ("the prove's", circ, pk.domain_size, pk.n_public + 1),
            ("long-row circuit", long, LONG_ROWS + 5, 5)):
        rows = prove_rows if c is circ else r1cs.build(c.constraints, dev)
        wit = fr_ntt.to_mont(bi.to_tensor([int(v) % bn254.R for v in c.w],
                                          dev))
        k4_cases.append(_hold(
            f"r1cs {label} A, B, C: 3 x {rows.nc} rows, {rows.nnz} "
            f"nonzeros ({3 * rows.nc - rows.n_short} rows on a warp), "
            f"{rows.coefs.shape[0]} coefficients, domain {m}",
            lambda: r1cs.evaluate(rows, wit, m, n_pub),
            lambda: r1cs.evaluate_plain(rows, wit, m, n_pub), 20, 1,
            *_r1cs_work(rows, wit, m)))
        del rows, wit
    return {kernels.MSM.name: k1_cases, kernels.EC_BATCH.name: k2_cases,
            kernels.R1CS.name: k4_cases}


def _groth16(dev, circ) -> tuple:
    """Phase 5: setup, prove and verify through the api entry points, the
    kernels' counts set to 0 before setup and read after verify.  (numbers,
    proving key, verifying key)"""
    from eigen_zkvm_tpu_torch import bench_groth16 as bg
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.groth16 import api
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    setup_prof = Prof("groth16.setup", dev, on=True)
    t0 = time.perf_counter()
    pk, vk = api.groth16_setup_inplace("bn128", circ,
                                       rng=bg.seeded(G16_SEED), device=dev,
                                       prof=setup_prof)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof = Prof("groth16.prove", dev, on=True)
    proof, pubs = api.groth16_prove_inplace(
        "bn128", circ, pk, rng=bg.seeded(G16_SEED + 1), prof=prof)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ok = api.groth16_verify_inplace("bn128", vk, proof, pubs)
    t3 = time.perf_counter()
    launches = kernels.counts()
    text = api.proof_to_json(proof, "bn128").encode()
    return dict(setup_s=t1 - t0, prove_s=t2 - t1, verify_s=t3 - t2,
                setup_stages=setup_prof.stages, stages=prof.stages,
                verified=ok, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                domain=pk.domain_size, n_vars=circ.n_vars,
                proof_sha256=hashlib.sha256(text).hexdigest()), pk, vk


def write_arg_air(directory: str, name: str, nbits: int,
                  hash_type: str = "GL", steps: str = "chain") -> dict:
    """An example AIR of eigen_zkvm_tpu_torch/examples/ (trace seed 0) as
    the files stark_prove reads: {"pil", "struct", "const", "cm"} -> path
    (the PIL JSON with its plookup and permutation identities; the struct
    bench_chain.chain_struct_json(nbits, ARG_QUERIES, hash_type, steps))."""
    import importlib

    from eigen_zkvm_tpu_torch import bench_chain

    mod = importlib.import_module(f"eigen_zkvm_tpu_torch.examples.{name}")
    pil, const_pols, make_trace = mod.build(nbits)
    files = {k: os.path.join(directory, f"{name}.{k}")
             for k in ("pil", "struct", "const", "cm")}
    with open(files["pil"], "w") as f:
        json.dump(bench_chain.pil_to_json(pil), f)
    with open(files["struct"], "w") as f:
        json.dump(bench_chain.chain_struct_json(nbits, ARG_QUERIES,
                                                hash_type, steps), f)
    const_pols.save(files["const"])
    make_trace().save(files["cm"])
    return files


def _cli_groth16(dev, circ, vk, pk) -> dict:
    """Phase 6: its circuit as a .r1cs file and its witness as a .wtns
    file, its seeded key as the port's key file, then groth16_prove,
    groth16_verify and generate_verifier through cli.main on the card (the
    prove's kernel counts set to 0 just before it); groth16_setup, prove
    and verify of a two-constraint circuit (x * y = 35, x + y = 12) through
    the CLI."""
    import torch

    from eigen_zkvm_tpu_torch import cli, kernels
    from eigen_zkvm_tpu_torch.algebraic import r1cs_file, witness
    from eigen_zkvm_tpu_torch.groth16 import api
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    def r1cs_of(constraints, n_vars, n_publics):
        return r1cs_file.R1CS(
            prime=circ.P, n_wires=n_vars, n_pub_out=0, n_pub_in=n_publics,
            n_prv_in=n_vars - n_publics - 1, n_labels=n_vars,
            constraints=constraints, wire_map=[])

    out, rcs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        p = {k: os.path.join(tmp, k) for k in (
            "circuit.r1cs", "witness.wtns", "pk.bin", "vk.json", "proof.json",
            "public.json", "verifier.sol", "toy.r1cs", "toy.json", "toy.pk",
            "toy.vk.json", "toy.proof.json", "toy.public.json")}
        t0 = time.perf_counter()
        r1cs_file.save_r1cs(p["circuit.r1cs"], r1cs_of(
            circ.constraints, circ.n_vars, circ.n_publics))
        t1 = time.perf_counter()
        witness.save_witness(p["witness.wtns"], circ.w, circ.P)
        t2 = time.perf_counter()
        api.save_pk(p["pk.bin"], pk)
        t3 = time.perf_counter()
        with open(p["vk.json"], "w") as f:
            f.write(api.vk_to_json(vk))
        out.update(write_r1cs_s=t1 - t0, write_wtns_s=t2 - t1,
                   save_pk_s=t3 - t2, bytes={k: os.path.getsize(p[k]) for k in
                                             ("circuit.r1cs", "witness.wtns",
                                              "pk.bin")})
        torch.cuda.synchronize()
        kernels.reset_counts()
        prof = Prof("cli.groth16_prove", dev, on=True)
        t0 = time.perf_counter()
        rcs["groth16_prove"] = cli.main([
            "groth16_prove", "--circuit", p["circuit.r1cs"], "--witness",
            p["witness.wtns"], "--pk", p["pk.bin"], "--proof",
            p["proof.json"], "--public_input", p["public.json"]], prof=prof)
        torch.cuda.synchronize()
        out.update(prove_s=time.perf_counter() - t0, stages=prof.stages,
                   launches=kernels.counts())
        t0 = time.perf_counter()
        rcs["groth16_verify"] = cli.main([
            "groth16_verify", "--vk", p["vk.json"], "--proof",
            p["proof.json"], "--public_input", p["public.json"]])
        t1 = time.perf_counter()
        rcs["generate_verifier"] = cli.main([
            "generate_verifier", "--vk", p["vk.json"], "--sol",
            p["verifier.sol"]])
        out.update(verify_s=t1 - t0, render_s=time.perf_counter() - t1)
        with open(p["verifier.sol"]) as f:
            out["render_matches"] = f.read() == \
                api.generate_verifier_from_vk(vk)

        toy = [({3: 1}, {4: 1}, {1: 1}), ({3: 1, 4: 1}, {0: 1}, {2: 1})]
        r1cs_file.save_r1cs(p["toy.r1cs"], r1cs_of(toy, 5, 2))
        witness.save_witness(p["toy.json"], [1, 35, 12, 5, 7], circ.P)
        t0 = time.perf_counter()
        rcs["toy groth16_setup"] = cli.main([
            "groth16_setup", "--circuit", p["toy.r1cs"], "--pk", p["toy.pk"],
            "--vk", p["toy.vk.json"]])
        rcs["toy groth16_prove"] = cli.main([
            "groth16_prove", "--circuit", p["toy.r1cs"], "--witness",
            p["toy.json"], "--pk", p["toy.pk"], "--proof",
            p["toy.proof.json"], "--public_input", p["toy.public.json"]])
        rcs["toy groth16_verify"] = cli.main([
            "groth16_verify", "--vk", p["toy.vk.json"], "--proof",
            p["toy.proof.json"], "--public_input", p["toy.public.json"]])
        out["toy_s"] = time.perf_counter() - t0
    out["rcs"] = rcs
    return out


def _arg_airs(dev) -> list:
    """Phase 7: each example AIR with arguments at each size, written to
    files, then stark_prove and stark_verify through cli.main on the card
    (the kernel counts set to 0 just before the prove, read just after);
    the zkin's sha256 against ARG_SHA256."""
    import torch

    from eigen_zkvm_tpu_torch import cli, kernels

    results = []
    for nbits in ARG_NBITS:
        for name in ARG_AIRS:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                files = write_arg_air(tmp, name, nbits)
                zkin = os.path.join(tmp, "zkin.json")
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                kernels.reset_counts()
                rc = cli.main(["stark_prove", "-s", files["struct"], "-p",
                               files["pil"], "-c", files["const"], "-m",
                               files["cm"], "-o", zkin])
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                launches = kernels.counts()
                rc_verify = cli.main(["stark_verify", "-s", files["struct"],
                                      "-p", files["pil"], "-c",
                                      files["const"], "-f", zkin])
                t3 = time.perf_counter()
                with open(zkin, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
            results.append(dict(
                name=name, nbits=nbits, write_s=t1 - t0, prove_s=t2 - t1,
                verify_s=t3 - t2, launches=launches, sha256=digest,
                ok=(rc == 0 and rc_verify == 0
                    and digest == ARG_SHA256[(name, nbits)]
                    and all(launches[k.name] > 0
                            for k in (kernels.NTT, kernels.POSEIDON)))))
            print(f"  {name} 2^{nbits}: files {t1 - t0:.2f} s, stark_prove "
                  f"{t2 - t1:.2f} s, stark_verify {t3 - t2:.2f} s, launches "
                  f"{launches}, sha256 {digest[:16]}..., equal to the host "
                  f"engine's: {digest == ARG_SHA256[(name, nbits)]}",
                  flush=True)
    return results


def _check_zkvm_kernels(dev, rng) -> dict:
    """Phase 8's widths: the NTT at the LDE of the RV32 machine's committed
    section, [2^16, 375] -> [2^17, 375], and Poseidon at that LDE's leaves
    (the plain version on one row in 8)."""
    from eigen_zkvm_tpu_torch import bench_zkvm, kernels
    from eigen_zkvm_tpu_torch.ops import ntt, poseidon
    import numpy as np

    nb, w = bench_zkvm.NBITS, ZKVM_WIDTH
    n, ext = 1 << nb, nb + 1
    x = _rand(rng, dev, (n, w))
    ntt_case = _hold(f"ntt interpolate [2^{nb},{w}]->[2^{ext},{w}]",
                     lambda: ntt.interpolate(x, nb, ext),
                     lambda: ntt.interpolate_plain(x, nb, ext), 10, 1,
                     8 * w * 3 * n,
                     _ntt_imads(nb, w, True) + _ntt_imads(ext, w, False))
    del x
    leaves = _rand(rng, dev, (2 * n, w),
                   np.tile(_edge_states(np), (1, -(-w // 12)))[:, :w])
    every = 8
    pos_case = _hold(f"poseidon leaves [2^{ext},{w}] (plain: 1 row in "
                     f"{every})",
                     lambda: poseidon.hash_leaves(leaves, w),
                     lambda: poseidon.hash_leaves_plain(leaves[::every], w),
                     10, 0, 8 * (leaves.numel() + leaves.shape[0] * 4),
                     POSEIDON_IMADS * _leaf_perms(w) * leaves.shape[0],
                     rows=slice(None, None, every))
    return {kernels.NTT.name: [ntt_case], kernels.POSEIDON.name: [pos_case]}


def _zkvm(dev) -> tuple:
    """Phase 8: the native executor's build, the ecrecover guest's
    chunking, the RV32IM machine's setup, chunks 0 and 1 traced, proved on
    the card and verified (chunk 0 with its busy share sampled), their
    digests and chain; then the MiniRV MEMWALK chain on the card.  Returns
    (its report, phase 10's inputs: the guest, the machine, its setup and
    struct, and the two chunks' zkins)."""
    from types import SimpleNamespace

    import torch

    from eigen_zkvm_tpu_torch import bench_zkvm, kernels
    from eigen_zkvm_tpu_torch.stark.engine import Engine
    from eigen_zkvm_tpu_torch.zkvm import lib, rv32_native
    from eigen_zkvm_tpu_torch.zkvm.rv32_lib import check_chain_publics

    out = {}
    t0 = time.perf_counter()
    rv32_native.build()
    rv32_native.library()
    out["native_build_s"] = time.perf_counter() - t0
    guest = bench_zkvm.Guest()
    out.update(cycles=guest.chunker.total_cycles,
               n_chunks=len(guest.chunker.chunks), execute_s=guest.execute_s)
    print(f"  guest: {out['cycles']} cycles, {out['n_chunks']} chunks of "
          f"2^{guest.nbits} rows (executed in {guest.execute_s:.3f} s; "
          f"executor built in {out['native_build_s']:.2f} s)", flush=True)
    engine = Engine(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    machine, setup, ss, times = bench_zkvm.setup_machine(
        guest, bench_zkvm.QUERIES, engine)
    out.update(times, n_cm=machine.pil.nCommitments,
               n_const=machine.pil.nConstants,
               n_plookups=len(machine.pil.plookupIdentities))
    print(f"  machine {times['machine_s']:.3f} s ({out['n_cm']} committed, "
          f"{out['n_const']} constant columns, {out['n_plookups']} "
          f"plookups), setup {times['setup_s']:.3f} s", flush=True)
    chunks, zkins = [], []
    for k in ZKVM_CHUNKS:
        r = bench_zkvm.prove_chunk(guest, machine, setup, ss, k, engine,
                                   busy=k == ZKVM_CHUNKS[0], keep_zkin=True)
        zkins.append(r.pop("zkin"))
        r["sha256_ok"] = r["zkin_sha256"] == ZKVM_SHA256[k]
        chunks.append(r)
        print(f"  chunk {k}: {r['rows']} states in {r['states_s']:.3f} s; "
              f"trace, prove, verify {r['wall_s']:.3f} s: "
              + ", ".join(f"{st} {t:.3f}" for st, t in r["stages"])
              + f"; launches {r['launches']}; digests hold "
              f"{r['digests_hold']}; zkin sha256 {r['zkin_sha256'][:16]}..., "
              f"equal to the host engine's: {r['sha256_ok']}", flush=True)
        if "busy_share" in r:
            print(f"  chunk {k}'s stark_gen: {r['stark_gen_s']:.3f} s, busy "
                  f"share {r['busy_share']} (nvidia-smi utilization.gpu, "
                  f"{r['busy_samples']} samples), device time "
                  f"{r['device_s']} s", flush=True)
    out["chunks"] = chunks
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["chain_holds"] = check_chain_publics([r["publics"] for r in chunks])
    state = SimpleNamespace(guest=guest, machine=machine, setup=setup, ss=ss,
                            zkins=zkins)

    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    proofs, pubs, _, _, _ = lib.zkvm_execute_and_prove(
        MEMWALK, MEMWALK_TAPE, n_bits=MEMWALK_NBITS, n_queries=2,
        ram_words=MEMWALK_RAM, device=dev)
    torch.cuda.synchronize()
    slots = [0] * MEMWALK_TAPE[1]
    for i in range(1, MEMWALK_TAPE[0] + 1):
        slots[(i - 1) % MEMWALK_TAPE[1]] = i
    out["memwalk"] = dict(chunks=len(proofs), s=time.perf_counter() - t0,
                          launches=kernels.counts(),
                          sum_ok=pubs[-1]["x5_out"] == sum(slots))
    print(f"  MiniRV MEMWALK: {len(proofs)} chunks of 2^{MEMWALK_NBITS} "
          f"rows proved, verified and chained in {out['memwalk']['s']:.2f} "
          f"s; launches {out['memwalk']['launches']}; result "
          f"{out['memwalk']['sum_ok']}", flush=True)
    return out, state


def _bigfield(dev) -> list:
    """Phase 9: the chain AIR (BN128, BLS12381) and the permutation example
    (BN128) at BIGFIELD_NBITS, written to files, then stark_prove through
    cli.main on the card (the kernel counts set to 0 just before it, read
    just after), the zkin's sha256 against BIGFIELD_SHA256, and
    stark_verify through the CLI."""
    import torch

    from eigen_zkvm_tpu_torch import bench_chain, cli, kernels

    results = []
    for (name, hash_type), want in BIGFIELD_SHA256.items():
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            if name == "chain":
                f = bench_chain.write_chain_files(
                    tmp, BIGFIELD_NBITS, BIGFIELD_WIDTH, BIGFIELD_QUERIES,
                    hash_type, "final")
                files = dict(f, struct=f["stark_struct"])
            else:
                files = write_arg_air(tmp, name, BIGFIELD_NBITS, hash_type,
                                      "final")
            zkin = os.path.join(tmp, "zkin.json")
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            kernels.reset_counts()
            rc = cli.main(["stark_prove", "-s", files["struct"], "-p",
                           files["pil"], "-c", files["const"], "-m",
                           files["cm"], "-o", zkin])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = kernels.counts()
            rc_verify = cli.main(["stark_verify", "-s", files["struct"],
                                  "-p", files["pil"], "-c", files["const"],
                                  "-f", zkin])
            t3 = time.perf_counter()
            with open(zkin, "rb") as fh:
                digest = hashlib.sha256(fh.read()).hexdigest()
        results.append(dict(
            name=name, hash=hash_type, write_s=t1 - t0, prove_s=t2 - t1,
            verify_s=t3 - t2, launches=launches, sha256=digest,
            ok=(rc == 0 and rc_verify == 0 and digest == want
                and launches[kernels.NTT.name] > 0
                and launches[kernels.POSEIDON_FR.name] > 0)))
        print(f"  {name} {hash_type} 2^{BIGFIELD_NBITS}: files "
              f"{t1 - t0:.2f} s, stark_prove {t2 - t1:.2f} s, stark_verify "
              f"{t3 - t2:.2f} s, launches {launches}, sha256 "
              f"{digest[:16]}..., equal to the host engine's: "
              f"{digest == want}", flush=True)
    return results


def _fr_states(dev, field, B: int, t: int, seed: int):
    """(inp [B, t-1, 4], init [B, 4]) of random values below 2^253 (or
    2^254 for BLS12-381's r), made on the card, with the first three states
    all 0, all r - 1, and 0 / r - 1 alternating (fewer states: the last of
    those)."""
    import torch

    from eigen_zkvm_tpu_torch.ops import bigint as bi

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = torch.randint(-2**63, 2**63 - 1, (B, t, 4), dtype=torch.int64,
                       device=dev, generator=gen)
    st[:, :, 3] &= (1 << (61 if field is bi.FR else 62)) - 1
    edge = bi.to_tensor([0, field.modulus - 1], dev)
    lanes = torch.arange(t, device=dev)
    edges = (edge[lanes * 0], edge[lanes * 0 + 1], edge[lanes & 1])
    for i, e in enumerate(edges[3 - min(B, 3):]):
        st[i] = e
    return st[:, 1:].contiguous(), st[:, 0].contiguous()


def _fr_products(t: int, n_p: int) -> int:
    """Field products of one permutation: x^5 (3) and the t x t mix on
    every lane of the 8 full rounds, x^5 on lane 0 and the sparse layer
    (t + t - 1) in each partial round."""
    return 8 * (3 * t + t * t) + n_p * (3 + t + t - 1)


def _check_bigfield_kernels(dev, rng) -> dict:
    """Phase 9's shapes: the Poseidon-Fr kernel against permute_plain on
    the card, bit for bit, with both times and its bound."""
    import torch

    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.hash import linearhash_big as lh
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import poseidon_fr
    import numpy as np

    cases = []
    n = 1 << (BIGFIELD_NBITS + 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, field, B, t in (
            (f"poseidon_fr BN128 leaves 2^{BIGFIELD_NBITS + 1} t=5", bi.FR,
             n, 5),
            ("poseidon_fr BN128 level 2^13 t=17", bi.FR, 1 << 13, 17),
            ("poseidon_fr BLS12381 level 2^13 t=17", bi.FR_BLS, 1 << 13,
             17),
            ("poseidon_fr BN128 level 2^9 t=17", bi.FR, 1 << 9, 17),
            ("poseidon_fr BN128 level of 1 node t=17", bi.FR, 1, 17)):
        inp, init = _fr_states(dev, field, B, t, B + t)
        n_out = poseidon_fr.poseidon(field).hash_index + 1
        n_p = poseidon_fr.poseidon(field).n_rounds_p(t)
        lanes, threads = poseidon_fr.plan(t, n_p, B, sms)
        cases.append(_hold(
            f"{label} (G={lanes}, {threads} threads a block)",
            lambda: poseidon_fr.permute(field, t, inp, init, n_out),
            lambda: poseidon_fr.permute_plain(field, t, inp, init, n_out),
            10, 0, 32 * B * (t + n_out),
            _fr_products(t, n_p) * B * IMAD_BN254))
        del inp, init
    # every width of both fields on every group size it allows and on
    # plan's pick (every instance of the kernel), at a batch that is no
    # multiple of a group or a block, exactly, against one plain call a
    # width on FR_EVERY_ROWS (permutations do not interact); one case a
    # field, whose ms, plain_ms and bound sum plan's pick and the plain
    # call over the widths
    B, rows = FR_EVERY_B, FR_EVERY_ROWS
    for field in (bi.FR, bi.FR_BLS):
        errs, ms, plain_ms, imads, nbytes, launches = [], 0.0, 0.0, 0, 0, 0
        for t in range(2, 18):
            inp, init = _fr_states(dev, field, B, t, 7 * t)
            n_p = poseidon_fr.poseidon(field).n_rounds_p(t)
            want, p_ms = _timed_once(lambda: poseidon_fr.permute_plain(
                field, t, inp[rows].cpu(), init[rows].cpu(), t))
            plain_ms += p_ms
            pick = poseidon_fr.plan(t, n_p, B, sms)[0]
            for lanes in poseidon_fr.lane_choices(t) + (None,):
                def run():
                    return poseidon_fr.permute(field, t, inp, init, t, lanes)
                errs.append(_max_abs_err(run()[rows].cpu(), want))
                k_ms = _time_ms(run, 3)
                launches += 1
                print(f"  poseidon_fr {field.name} t={t} B={B} G="
                      f"{lanes or pick}{'' if lanes else ' (plan)'}: "
                      f"{k_ms:.3f} ms, max_abs_err {errs[-1]}")
            ms += k_ms  # the last: plan's pick
            imads += _fr_products(t, n_p) * B * IMAD_BN254
            nbytes += 32 * B * 2 * t
            print(f"  poseidon_fr {field.name} t={t} plain on "
                  f"{len(rows)} rows (CPU): {p_ms:.3f} ms", flush=True)
        b = _bound(nbytes, imads)
        cases.append(dict(
            label=f"poseidon_fr {field.name} every t=2..17 x every group "
                  f"size and plan's pick, B={B} ({launches} launches held; "
                  f"ms and bound: plan's pick, plain_ms: the plain version "
                  f"on {len(rows)} rows copied to the CPU, summed over the "
                  f"widths)",
            err=max(errs), ms=ms, plain_ms=plain_ms, **b))
        print(f"{cases[-1]['label']}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, max_abs_err {max(errs)}", flush=True)
    # 2^14 rows of width 375: 125 Fr a row, seven t = 17 calls and one
    # t = 14 in one sponge
    w, H = ZKVM_WIDTH, 1 << 14
    rows = _rand(rng, dev, (H, w),
                 np.tile(_edge_states(np), (1, -(-w // 12)))[:, :w])
    n3 = -(-w // 3)
    pos = poseidon_fr.poseidon(bi.FR)
    prods = sum(_fr_products(min(16, n3 - i) + 1,
                             pos.n_rounds_p(min(16, n3 - i) + 1))
                for i in range(0, n3, 16))
    cases.append(_hold(
        f"poseidon_fr BN128 leaves [2^14,{w}] (t=17 x7, t=14)",
        lambda: lh.hash_leaves(bi.FR, rows),
        lambda: lh.hash_leaves_plain(bi.FR, rows), 10, 0,
        8 * H * w + 32 * H, prods * H * IMAD_BN254))
    return {kernels.POSEIDON_FR.name: cases}


def _bigfield_split(dev) -> list:
    """The leaves' and each level's time in one BN128 tree over 2^17
    random rows of width 12 and one of width 0 (bench_poseidon_fr.
    tree_split: CUDA events at build_nodes' on_call, the mean of three
    builds after a warm-up)."""
    from eigen_zkvm_tpu_torch import bench_poseidon_fr

    out = []
    for width in (BIGFIELD_WIDTH, 0):
        sp = bench_poseidon_fr.tree_split(dev, width)
        out.append(sp)
        print(f"  tree 2^17 x {width} (BN128), {sp['launches']} Poseidon-Fr"
              f" launches: {sp['build_ms']:.3f} ms; leaves (and the store's"
              f" zeroing) {sp['steps_ms'][0]:.3f} ms; "
              + "; ".join(f"level of {n} {ms:.3f} ms" for n, ms in
                          zip(sp["levels"], sp["steps_ms"][1:])), flush=True)
    return out


def _recursion(dev, state, on_layer) -> dict:
    """Phase 10: c12 and recursive1 of phase 8's two chunk zkins, then
    their chained aggregation, on the card (each layer's kernel counts set
    to 0 just before it, read just after); the five zkins' digests and the
    super-chunk publics; `on_layer` keeps what phase 12 renders.  (report,
    run_layers' zkins and the aggregation's setup: phase 11's input)"""
    from eigen_zkvm_tpu_torch import bench_recursion
    from eigen_zkvm_tpu_torch.recursion.compressor12 import ChainMap
    from eigen_zkvm_tpu_torch.stark.engine import Engine

    records, out = bench_recursion.run_layers(
        state.zkins, state.setup, state.ss, Engine(dev), RECURSION_QUERIES,
        RECURSION_FORCE, ChainMap.for_machine(state.machine),
        log=lambda line: print(line, flush=True), on_layer=on_layer)
    for r in records:
        r["sha256_ok"] = r["zkin_sha256"] == RECURSION_SHA256[r["layer"]]
    return dict(layers=records, super_publics_hold=(
        bench_recursion.super_publics_hold(
            state.guest, state.machine, out["aggregation"], ZKVM_CHUNKS[0],
            ZKVM_CHUNKS[-1]))), out


def _check_recursion_kernels(dev, rng, layer: dict) -> dict:
    """Phase 10's widths, at a recursive1 layer's shapes: the NTT at the LDE
    of each of its sections (committed, constant, stage 3, Q) from 2^n to
    2^(n+1) rows, and Poseidon at their leaves (the plain version on one
    row in 8)."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.ops import ntt, poseidon
    import numpy as np

    nb = layer["n_bits"]
    n, ext = 1 << nb, nb + 1
    widths = {s.replace("_2ns", ""): w for s, w in layer["widths"].items()}
    widths["const"] = layer["n_const"]
    ntt_cases, pos_cases = [], []
    every = 8
    for name, w in widths.items():
        if w == 0:
            continue
        x = _rand(rng, dev, (n, w))
        ntt_cases.append(_hold(
            f"ntt interpolate {name} [2^{nb},{w}]->[2^{ext},{w}]",
            lambda: ntt.interpolate(x, nb, ext),
            lambda: ntt.interpolate_plain(x, nb, ext), 10, 1, 8 * w * 3 * n,
            _ntt_imads(nb, w, True) + _ntt_imads(ext, w, False)))
        del x
        if w <= 4:   # a leaf of four values or fewer is the row itself
            continue
        leaves = _rand(rng, dev, (2 * n, w),
                       np.tile(_edge_states(np), (1, -(-w // 12)))[:, :w])
        pos_cases.append(_hold(
            f"poseidon leaves {name} [2^{ext},{w}] (plain: 1 row in "
            f"{every})", lambda: poseidon.hash_leaves(leaves, w),
            lambda: poseidon.hash_leaves_plain(leaves[::every], w), 10, 0,
            8 * (leaves.numel() + leaves.shape[0] * 4),
            POSEIDON_IMADS * _leaf_perms(w) * leaves.shape[0],
            rows=slice(None, None, every)))
        del leaves
    return {kernels.NTT.name: ntt_cases, kernels.POSEIDON.name: pos_cases}


def _wrap(dev, agg: dict, on_layer) -> tuple:
    """Phase 11: the final BN128 layer of phase 10's aggregated proof, then
    its Groth16 wrap, on the card (bench_e2e.run_final_and_wrap: each
    stage's kernel counts set to 0 just before it, read just after; the
    wrap's split between setup and prove), its digests held to
    WRAP_SHA256; `on_layer` keeps what phase 12 renders.  (report, the
    final layer's record, the Wrap)"""
    from eigen_zkvm_tpu_torch import bench_e2e
    from eigen_zkvm_tpu_torch.stark.engine import Engine

    final, rec, _, wrap = bench_e2e.run_final_and_wrap(agg, Engine(dev), dev,
                                                       on_layer)
    rec["sha256_ok"] = {k: rec["digests"][k] == WRAP_SHA256[k]
                        for k in WRAP_SHA256}
    print(f"  the digests equal the host engine's: {rec['sha256_ok']}",
          flush=True)
    return dict(final=final, wrap=rec), final, wrap


def _check_wrap_kernels(dev, rng, final: dict, wrap) -> dict:
    """Phase 11's shapes: the NTT at the LDE of each of the final layer's
    sections (committed, constant, stage 3, Q), Poseidon-Fr at their
    leaves (BN128, the plain version on one row in 16) and at the first
    tree level (2^(n+1) / 16 nodes of t = 17, the plain version on one in
    16); then K1, K2 and K4 on the wrap's proving key and witness
    (_check_groth16_shapes) and K3 on the prove's first coset transform
    (A's evaluations over the 2^22 domain)."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.groth16 import groth16 as g16
    from eigen_zkvm_tpu_torch.hash import linearhash_big as lh
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import fr_ntt, ntt, poseidon_fr, r1cs
    import numpy as np

    nb = final["n_bits"]
    n, ext = 1 << nb, nb + 1
    widths = {s.replace("_2ns", ""): w for s, w in final["widths"].items()}
    widths["const"] = final["n_const"]
    pos = poseidon_fr.poseidon(bi.FR)
    ntt_cases, fr_cases = [], []
    every = 16
    for name, w in widths.items():
        if not w:
            continue
        x = _rand(rng, dev, (n, w))
        ntt_cases.append(_hold(
            f"ntt interpolate final {name} [2^{nb},{w}]->[2^{ext},{w}]",
            lambda: ntt.interpolate(x, nb, ext),
            lambda: ntt.interpolate_plain(x, nb, ext), 10, 1, 8 * w * 3 * n,
            _ntt_imads(nb, w, True) + _ntt_imads(ext, w, False)))
        del x
        if w <= 4:   # packed into one Fr: no permutation
            continue
        leaves = _rand(rng, dev, (2 * n, w),
                       np.tile(_edge_states(np), (1, -(-w // 12)))[:, :w])
        n3 = -(-w // 3)
        prods = sum(_fr_products(min(16, n3 - i) + 1,
                                 pos.n_rounds_p(min(16, n3 - i) + 1))
                    for i in range(0, n3, 16))
        fr_cases.append(_hold(
            f"poseidon_fr BN128 leaves final {name} [2^{ext},{w}] (plain: "
            f"1 row in {every})", lambda: lh.hash_leaves(bi.FR, leaves),
            lambda: lh.hash_leaves_plain(bi.FR, leaves[::every]), 5, 0,
            8 * leaves.numel() + 32 * 2 * n, prods * 2 * n * IMAD_BN254,
            rows=slice(None, None, every)))
        del leaves
    B = (2 * n) // 16
    inp, init = _fr_states(dev, bi.FR, B, 17, B)
    init.zero_()     # a node's capacity is 0
    fr_cases.append(_hold(
        f"poseidon_fr BN128 final tree level {B} nodes t=17 (G="
        f"{poseidon_fr.plan(17, pos.n_rounds_p(17), B)[0]}; plain: 1 in "
        f"{every})",
        lambda: poseidon_fr.permute(bi.FR, 17, inp, init, 1),
        lambda: poseidon_fr.permute_plain(bi.FR, 17, inp[::every],
                                          init[::every], 1), 10, 0,
        32 * B * 18, _fr_products(17, pos.n_rounds_p(17)) * B * IMAD_BN254,
        rows=slice(None, None, every)))
    del inp, init
    out = {kernels.NTT.name: ntt_cases, kernels.POSEIDON_FR.name: fr_cases}

    # K3: the prove's first coset transform, on A's evaluations (the
    # prove's R1CS rows, from groth16's cache)
    pk, circ = wrap.pk, wrap.circuit
    m = pk.domain_size
    log_m = m.bit_length() - 1
    rows = g16.r1cs_rows(circ.constraints, dev)
    wit = fr_ntt.to_mont(bi.to_tensor([int(v) % bn254.R for v in circ.w],
                                      dev))
    a = r1cs.evaluate(rows, wit, m, pk.n_public + 1)[0].contiguous()
    del wit
    out.update(_check_groth16_shapes(dev, circ, pk, rows))
    out[kernels.FR_NTT.name] = [_hold(
        f"fr to_coset 2^{log_m}, the wrap's A evaluations",
        lambda: fr_ntt.to_coset(a, log_m),
        lambda: fr_ntt.to_coset_plain(a, log_m), 10, 1, 64 * m,
        2 * (m // 2) * log_m * IMAD_BN254 + m * IMAD_BN254)]
    return out


def _circom(dev, layers: dict) -> tuple:
    """Phase 12: the verifiers of phase 10's and 11's layers that `layers`
    kept (bench_circom.layer_keeper) rendered as circom text, then
    bench_circom's two routes on the card at the committed sizes (each
    route's kernel counts set to 0 at its start, read around each step),
    every digest held to CIRCOM_SHA256.  (report, GLMulChain's builder,
    its proving key)"""
    from eigen_zkvm_tpu_torch import bench_circom as bc

    renders = {}
    for label, kept in layers.items():
        t0 = time.perf_counter()
        text = bc.render(*kept, bc.LAYER_OPTIONS[label.split()[0]])
        renders[label] = dict(s=time.perf_counter() - t0, bytes=len(text),
                              sha256=bc.sha256(text.encode()))
        print(f"  render {label} ({bc.LAYER_OPTIONS[label.split()[0]]}): "
              f"{len(text)} bytes in {renders[label]['s']:.3f} s", flush=True)
    t0 = time.perf_counter()
    g, b, pk = bc.groth16_route(bc.source(bc.GLMUL, bc.GLMUL_N),
                                bc.GLMUL_INPUTS, dev)
    c, _ = bc.compressor_route(bc.source(bc.GLSQUARE, bc.GLSQUARE_N),
                               bc.GLSQUARE_INPUTS, dev)
    for name, rec, shape in (
            (f"GLMulChain({bc.GLMUL_N}) groth16", g,
             f"{g['constraints']} constraints after O2, "
             f"{g['wires']} wires, domain 2^{g['domain'].bit_length() - 1}"),
            (f"GLSquareChain({bc.GLSQUARE_N}) compressor", c,
             f"{c['constraints']} constraints, 2^{c['n_bits']} rows "
             f"({c['n_used']} used), FRI steps {c['steps']}")):
        print(f"  {name}: {shape}; {rec['wall_s']:.3f} s: "
              + ", ".join(f"{st} {t:.3f}" for st, t in rec["stages"])
              + f"; launches {rec['launches']}; peak device memory "
              f"{(rec['peak_bytes'] or 0) / 2**30:.3f} GiB", flush=True)
    digests = {label: r["sha256"] for label, r in renders.items()}
    digests.update({f"glmul {k}": v for k, v in g["digests"].items()})
    digests.update({f"glsquare {k}": v for k, v in c["digests"].items()})
    return dict(renders=renders, groth16=g, compressor=c,
                routes_s=time.perf_counter() - t0, digests=digests,
                sha256_ok={k: digests.get(k) == v
                           for k, v in CIRCOM_SHA256.items()}), b, pk


def _check_circom_kernels(dev, circ, pk) -> dict:
    """Phase 12's shape: K4 on GLMulChain's three matrices (the prove's
    r1cs.Rows, from groth16's cache: rows of 65 nonzeros with power-of-two
    coefficients on a warp each) against evaluate_plain, exactly."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bn254
    from eigen_zkvm_tpu_torch.groth16 import groth16 as g16
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import fr_ntt, r1cs

    rows = g16.r1cs_rows(circ.constraints, dev)
    wit = fr_ntt.to_mont(bi.to_tensor([int(v) % bn254.R for v in circ.w],
                                      dev))
    m, n_pub = pk.domain_size, pk.n_public + 1
    return {kernels.R1CS.name: [_hold(
        f"r1cs GLMulChain A, B, C: 3 x {rows.nc} rows, {rows.nnz} "
        f"nonzeros ({3 * rows.nc - rows.n_short} rows on a warp), "
        f"{rows.coefs.shape[0]} coefficients, domain {m}",
        lambda: r1cs.evaluate(rows, wit, m, n_pub),
        lambda: r1cs.evaluate_plain(rows, wit, m, n_pub), 20, 1,
        *_r1cs_work(rows, wit, m))]}


def _guests(dev) -> dict:
    """Phase 13: the committed guest ELFs on the native executor, then the
    EVM transfer guest proved on the card (bench_guests.prove_transfer:
    the NTT's and Poseidon's counts set to 0 just before, read just
    after), each chunk's zkin sha256 against GUESTS_SHA256."""
    from eigen_zkvm_tpu_torch import bench_guests

    out = {"elfs": bench_guests.run_elfs()}
    for r in out["elfs"]:
        print(f"  {r['name']}: {r['cycles']} cycles in {r['s']:.3f} s on "
              f"the native executor, a0 {r['a0']} (oracle {r['want']}): "
              f"{r['ok']}", flush=True)
    out.update(bench_guests.prove_transfer(dev))
    out["sha256_ok"] = out["zkin_sha256"] == list(GUESTS_SHA256)
    return out


def _check_guests_kernels(dev, rng, width: int) -> dict:
    """Phase 13's widths: the NTT at the LDE of the transfer machine's
    committed section, [2^11, width] -> [2^12, width] (the iNTT one leaf of
    an odd column count, then the coset NTT), and Poseidon at that LDE's
    leaves, every row against the plain version."""
    from eigen_zkvm_tpu_torch import bench_guests, kernels
    from eigen_zkvm_tpu_torch.ops import ntt, poseidon
    import numpy as np

    nb, w = bench_guests.NBITS, width
    n, ext = 1 << nb, nb + 1
    x = _rand(rng, dev, (n, w))
    ntt_case = _hold(f"ntt interpolate guests [2^{nb},{w}]->[2^{ext},{w}]",
                     lambda: ntt.interpolate(x, nb, ext),
                     lambda: ntt.interpolate_plain(x, nb, ext), 10, 1,
                     8 * w * 3 * n,
                     _ntt_imads(nb, w, True) + _ntt_imads(ext, w, False))
    del x
    leaves = _rand(rng, dev, (2 * n, w),
                   np.tile(_edge_states(np), (1, -(-w // 12)))[:, :w])
    pos_case = _hold(f"poseidon leaves guests [2^{ext},{w}]",
                     lambda: poseidon.hash_leaves(leaves, w),
                     lambda: poseidon.hash_leaves_plain(leaves, w), 10, 0,
                     8 * (leaves.numel() + leaves.shape[0] * 4),
                     POSEIDON_IMADS * _leaf_perms(w) * leaves.shape[0])
    return {kernels.NTT.name: [ntt_case], kernels.POSEIDON.name: [pos_case]}


def _bls(dev) -> tuple:
    """Phase 14: bench_groth16's synthetic circuit over BLS12-381's r at
    phase 5's shape through groth16_setup_inplace, groth16_prove_inplace
    and groth16_verify_inplace("bls12381", ...), the kernels' counts set
    to 0 before setup and read after verify; then the verify of a changed
    public.  (numbers, the circuit, the proving key)"""
    from eigen_zkvm_tpu_torch import bench_groth16 as bg
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bls12_381
    from eigen_zkvm_tpu_torch.groth16 import api
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    import torch

    t0 = time.perf_counter()
    circ = bg.synthetic(G16_CONSTRAINTS, 2, G16_SEED, prime=bls12_381.R)
    circuit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    setup_prof = Prof("groth16.setup", dev, on=True)
    t0 = time.perf_counter()
    pk, vk = api.groth16_setup_inplace("bls12381", circ,
                                       rng=bg.seeded(G16_SEED), device=dev,
                                       prof=setup_prof)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prof = Prof("groth16.prove", dev, on=True)
    proof, pubs = api.groth16_prove_inplace(
        "bls12381", circ, pk, rng=bg.seeded(G16_SEED + 1), prof=prof)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ok = api.groth16_verify_inplace("bls12381", vk, proof, pubs)
    t3 = time.perf_counter()
    launches = kernels.counts()
    changed = [(pubs[0] + 1) % bls12_381.R] + list(pubs[1:])
    rejected = not api.groth16_verify_inplace("bls12381", vk, proof, changed)
    t4 = time.perf_counter()
    text = api.proof_to_json(proof, "bls12381").encode()
    return dict(circuit_s=circuit_s, setup_s=t1 - t0, prove_s=t2 - t1,
                verify_s=t3 - t2, changed_verify_s=t4 - t3,
                setup_stages=setup_prof.stages, stages=prof.stages,
                verified=ok, tampered_rejected=rejected, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                domain=pk.domain_size, n_vars=circ.n_vars,
                proof_sha256=hashlib.sha256(text).hexdigest()), circ, pk


def _check_bls_kernels(dev, rng, circ, pk) -> dict:
    """Phase 14's holds, after its counts are read: the four Groth16
    kernels at BLS12-381 against their plain versions, exactly.  K1 on the
    prove's own A (G1) and B2 (G2) inputs against ec.msm_stages_plain, and
    at BLS_CHECK_N points with phase 3's edge cases (infinity points, a
    duplicated point, scalars 0, 1 and r - 1, a hot bucket, digits at
    +2^(c-1) and 2^(c-1) + 1 with carries, bit 254 set) against the
    double-and-add ec.msm_plain; K2 at setup's lane counts (0, 1, 2 and
    r - 1 first, a quarter zero; the G2 batch checked on one lane in 8, G1
    on one in 32); K3 forward, inverse and the coset round trip at the
    phase's domain, its product by a constant and the quotient; K4 on the
    prove's rows.  {kernel name: cases}; the first case of each is the one
    the kernels' line reports."""
    import random

    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bls12_381
    from eigen_zkvm_tpu_torch.groth16 import groth16 as g16
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import ec, fr_ntt, r1cs

    R, F = bls12_381.R, bi.FR_BLS
    G1, G2 = ec.G1_BLS, ec.G2_BLS
    prng = random.Random(int(rng.integers(1 << 30)))

    def pt_bytes(g):   # bytes of one affine point
        return 16 * g.field.words * g.deg

    wit = bi.to_tensor([int(v) % R for v in circ.w], dev)
    k1_cases = []
    for g, label, pts in ((G1, "A", pk.a_query), (G2, "B2", pk.b2_query)):
        n = pts.shape[0]
        k1_cases.append(_hold(
            f"msm {g} {label} query, the prove's inputs: n={n}, "
            f"c={ec.window_bits(n)} (plain stages)",
            lambda: ec.msm(g, pts, wit),
            lambda: ec.msm_stages_plain(g, pts, wit), 3, 0,
            n * (32 + pt_bytes(g)) + pt_bytes(g),
            _msm_products(pts, wit, g.deg == 2, 255) * IMAD_BLS_FQ))
    del wit

    n = BLS_CHECK_N
    c = ec.window_bits(n)
    half, W = 1 << (c - 1), ec.n_windows(c, 255)
    for g in (G1, G2):
        gen = ec.generator(g)
        pts = ec.scalar_mul_batch(g, gen, bi.to_tensor(
            [prng.randrange(1, R) for _ in range(n)], dev))
        pts[5] = 0
        pts[100:103] = 0
        pts[9] = pts[8]
        ks = [prng.randrange(R) for _ in range(n)]
        ks[0], ks[1], ks[2] = 0, 1, R - 1
        ks[3] = sum(half << (c * w) for w in range(W - 1)) % (1 << 254)
        ks[4] = sum((half + 1) << (c * w) for w in range(W - 1)) % (1 << 254)
        ks[6] = (1 << 254) | (1 << 253)
        ks[7] = (1 << 254) + prng.randrange(R - (1 << 254))
        for i in range(10, n // 2):
            ks[i] = i & 1
        S = bi.to_tensor(ks, dev)
        k1_cases.append(_hold(
            f"msm {g} n={n} edge cases (double-and-add)",
            lambda: ec.msm(g, pts, S), lambda: ec.msm_plain(g, pts, S), 5, 0,
            n * (32 + pt_bytes(g)) + pt_bytes(g),
            _msm_products(pts, S, g.deg == 2, 255) * IMAD_BLS_FQ))
        del pts, S

    n1 = 3 + 2 * pk.n_vars + pk.l_query.shape[0] + pk.n_public + 1 \
        + pk.h_query.shape[0]
    n2 = 3 + pk.n_vars
    k2_cases = []
    for g, n, step in ((G2, n2, 8), (G1, n1, 32)):
        S = _random_scalars(dev, n, n, R)
        gen = ec.generator(g)
        rows = slice(0, n, step)
        k2_cases.append(_hold(
            f"ec_batch {g} {n} lanes (setup's count), plain on one lane in "
            f"{step}", lambda: ec.scalar_mul_batch(g, gen, S),
            lambda: ec.scalar_mul_batch_plain(g, gen, S[rows]), 2, 0,
            n * 32 + n * pt_bytes(g),
            _fixed_base_products(S, g.deg == 2) * IMAD_BLS_FQ, rows=rows))
        del S

    m = pk.domain_size
    log_m = m.bit_length() - 1
    x = bi.mont_ints(F, [prng.randrange(R) for _ in range(m)], dev)
    prods = (m // 2) * log_m * IMAD_BN254
    k = fr_ntt.mont_const(fr_ntt.z_coset_inv(m, F), dev, F)
    k3_cases = [
        _hold(f"fr_ntt Fr381 2^{log_m}",
              lambda: fr_ntt.ntt(x, log_m, field=F),
              lambda: fr_ntt.ntt_plain(x, log_m, field=F), 10, 1, 64 * m,
              prods),
        _hold(f"fr_ntt Fr381 inverse 2^{log_m}",
              lambda: fr_ntt.ntt(x, log_m, inverse=True, field=F),
              lambda: fr_ntt.ntt_plain(x, log_m, inverse=True, field=F), 10,
              1, 64 * m, prods),
        _hold(f"fr Fr381 coset round trip 2^{log_m} (to_coset, from_coset)",
              lambda: fr_ntt.from_coset(fr_ntt.to_coset(x, log_m, field=F),
                                        log_m, field=F),
              lambda: fr_ntt.from_coset_plain(
                  fr_ntt.to_coset_plain(x, log_m, field=F), log_m, field=F),
              10, 1, 64 * m, 3 * prods + 2 * m * IMAD_BN254),
        _hold(f"fr Fr381 mul 2^{log_m} by a constant",
              lambda: fr_ntt.mul(x, k, field=F),
              lambda: fr_ntt.mul_plain(x, k, field=F), 10, 1, 2 * 32 * m,
              m * IMAD_BN254),
        _hold(f"fr Fr381 quotient 2^{log_m}",
              lambda: fr_ntt.quotient(x, x, x, k, field=F),
              lambda: fr_ntt.quotient_plain(x, x, x, k, field=F), 10, 1,
              4 * 32 * m, 2 * m * IMAD_BN254)]
    del x

    rows = g16.r1cs_rows(circ.constraints, dev, F)
    wit = fr_ntt.to_mont(bi.to_tensor([int(v) % R for v in circ.w], dev),
                         field=F)
    n_pub = pk.n_public + 1
    k4_cases = [_hold(
        f"r1cs Fr381 the prove's A, B, C: 3 x {rows.nc} rows, {rows.nnz} "
        f"nonzeros ({3 * rows.nc - rows.n_short} rows on a warp), "
        f"{rows.coefs.shape[0]} coefficients, domain {m}",
        lambda: r1cs.evaluate(rows, wit, m, n_pub),
        lambda: r1cs.evaluate_plain(rows, wit, m, n_pub), 20, 1,
        *_r1cs_work(rows, wit, m))]
    return {kernels.MSM_BLS.name: k1_cases,
            kernels.EC_BATCH_BLS.name: k2_cases,
            kernels.FR_NTT_BLS.name: k3_cases,
            kernels.R1CS_BLS.name: k4_cases}


def _fold_plain(digs):
    """poseidon.fold_root_pow2 with every level on hash_n_plain."""
    from eigen_zkvm_tpu_torch.ops import poseidon

    while digs.shape[-2] > 1:
        digs = poseidon.hash_n_plain(digs.reshape(-1, 8)).reshape(
            *digs.shape[:-2], digs.shape[-2] // 2, 4)
    return digs[..., 0, :]


def _check_sharded_kernels(dev, rng) -> dict:
    """Phase 16: the NTT and Poseidon-GL at the local shapes a rank of the
    four-rank sharded prove gives them (2^20 x 8: a pol block's LDE, a row
    block's leaves, the first level of the block's subtree, the top fold
    over the four sub-roots), against their plain versions."""
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.ops import ntt, poseidon
    import numpy as np

    edge = _edge_states(np)

    def rand(*shape, edge_rows=None):
        return _rand(rng, dev, shape, edge_rows)

    n, ext = 1 << NBITS, NBITS + 1
    w_l, r_l = WIDTH // SHARDS, (2 * n) // SHARDS
    x = rand(n, w_l)
    ntt_cases = [_hold(
        f"ntt sharded pol block [2^{NBITS},{w_l}]->[2^{ext},{w_l}]",
        lambda: ntt.interpolate(x, NBITS, ext),
        lambda: ntt.interpolate_plain(x, NBITS, ext), 10, 0,
        8 * w_l * 3 * n,
        _ntt_imads(NBITS, w_l, True) + _ntt_imads(ext, w_l, False))]
    del x
    rows = rand(r_l, WIDTH, edge_rows=edge[:, :8])
    level = rand(r_l // 2, 8, edge_rows=edge[:, :8])
    tops = rand(SHARDS, 4)
    lg = r_l.bit_length() - 1
    pos_cases = [
        _hold(f"poseidon sharded row block leaves [2^{lg},{WIDTH}]",
              lambda: poseidon.hash_leaves(rows, WIDTH),
              lambda: poseidon.hash_leaves_plain(rows, WIDTH), 10, 0,
              8 * (rows.numel() + r_l * 4),
              POSEIDON_IMADS * _leaf_perms(WIDTH) * r_l),
        _hold(f"poseidon sharded subtree level [2^{lg - 1},8]",
              lambda: poseidon.hash_n(level),
              lambda: poseidon.hash_n_plain(level), 10, 0,
              8 * (level.numel() + level.shape[0] * 4),
              POSEIDON_IMADS * level.shape[0]),
        _hold(f"poseidon sharded top fold [{SHARDS},4]",
              lambda: poseidon.fold_root_pow2(tops),
              lambda: _fold_plain(tops), 10, 0, 8 * (tops.numel() + 4),
              POSEIDON_IMADS * (SHARDS - 1))]
    return {kernels.NTT.name: ntt_cases, kernels.POSEIDON.name: pos_cases}


def _sharded(dev, files: dict) -> dict:
    """Phase 16: SHARDS ranks on this card over gloo (parallel/launch.py;
    the kernels already built, each rank loads them): phase 4's files
    through sharded_prove, then make_sharded_commit on a COMMIT_GRID grid
    against the single-device extend_and_merkelize roots of the same
    traces.  Returns the phase's record."""
    import numpy as np
    import torch

    from eigen_zkvm_tpu_torch import bench_sharded
    from eigen_zkvm_tpu_torch.parallel import launch

    torch.cuda.empty_cache()   # the ranks share this card
    t0 = time.perf_counter()
    want = bench_sharded.commit_reference(COMMIT_SEED, COMMIT_BATCH, NBITS,
                                          WIDTH, dev)
    rec = {"reference_s": time.perf_counter() - t0}
    with launch.RankPool(SHARDS, "gloo", device=str(dev)) as pool:
        rec["pool_up_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        recs = pool.run(bench_sharded.prove_files, files, 1, True, None)
        rec["prove"] = bench_sharded.summarise("gloo", "gloo", recs,
                                               time.perf_counter() - t1)
        t1 = time.perf_counter()
        commits = pool.run(bench_sharded.commit_traces, COMMIT_SEED,
                           COMMIT_BATCH, NBITS, WIDTH, data=COMMIT_GRID[0])
        rec["commit_s"] = time.perf_counter() - t1
    b_l = COMMIT_BATCH // COMMIT_GRID[0]
    rec["commit_roots_equal"] = all(np.array_equal(
        c["roots"], want[c["coords"][0] * b_l : (c["coords"][0] + 1) * b_l])
        for c in commits)
    rec["commit_launches"] = [c["launches"] for c in commits]
    rec["commit_collectives"] = commits[0]["collectives"]
    rec["commit_peak_bytes"] = [c["peak_bytes"] for c in commits]
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _bridge(dev) -> dict:
    """Phase 15: bench_bridge.toy_inner's BN254 proof on the card, then
    bench_bridge.bridge_part of it through groth16_setup_inplace,
    groth16_prove_inplace and groth16_verify_inplace("bls12381", ...), the
    kernels' counts set to 0 before setup and read after verify; then the
    verify of a changed public."""
    from eigen_zkvm_tpu_torch import bench_bridge as bb
    from eigen_zkvm_tpu_torch import bench_groth16 as bg
    from eigen_zkvm_tpu_torch import kernels
    from eigen_zkvm_tpu_torch.curves import bls12_381
    from eigen_zkvm_tpu_torch.groth16 import api
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    import torch

    t0 = time.perf_counter()
    inner = bb.toy_inner(dev)
    t1 = time.perf_counter()
    circ = bb.bridge_part(*inner)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    setup_prof = Prof("groth16.setup", dev, on=True)
    pk, vk = api.groth16_setup_inplace("bls12381", circ,
                                       rng=bg.seeded(bb.OUTER_SEED),
                                       device=dev, prof=setup_prof)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    prof = Prof("groth16.prove", dev, on=True)
    proof, pubs = api.groth16_prove_inplace(
        "bls12381", circ, pk, rng=bg.seeded(bb.OUTER_SEED + 1), prof=prof)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    ok = api.groth16_verify_inplace("bls12381", vk, proof, pubs)
    t5 = time.perf_counter()
    launches = kernels.counts()
    changed = [(pubs[0] + 1) % bls12_381.R] + list(pubs[1:])
    rejected = not api.groth16_verify_inplace("bls12381", vk, proof, changed)
    text = api.proof_to_json(proof, "bls12381").encode()
    return dict(inner_s=t1 - t0, build_s=t2 - t1, setup_s=t3 - t2,
                prove_s=t4 - t3, verify_s=t5 - t4,
                changed_verify_s=time.perf_counter() - t5,
                setup_stages=setup_prof.stages, stages=prof.stages,
                constraints=len(circ.constraints), n_vars=circ.n_vars,
                domain=pk.domain_size, verified=ok,
                tampered_rejected=rejected, launches=launches,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                proof_sha256=hashlib.sha256(text).hexdigest())


def _check_bridge_kernels(dev) -> list:
    """Phase 15's holds: K3 at the full bridge's domain 2^BRIDGE_NTT_BITS
    (fr_ntt.plan's three passes) over BLS12-381's r, forward, inverse and
    the coset round trip, against ntt_plain's radix-2 ladder (one call
    each), exactly; values below 2^254 made on the card (0, 1, 2 and r - 1
    first, every fourth of the rest 0), canonical, so Montgomery words."""
    from eigen_zkvm_tpu_torch.curves import bls12_381
    from eigen_zkvm_tpu_torch.ops import bigint as bi
    from eigen_zkvm_tpu_torch.ops import fr_ntt

    F, L = bi.FR_BLS, BRIDGE_NTT_BITS
    m = 1 << L
    x = _random_scalars(dev, m, 15, bls12_381.R)
    prods = (m // 2) * L * IMAD_BN254
    passes = fr_ntt.plan(L)
    cases = [
        _hold(f"fr_ntt Fr381 2^{L} (the bridge's domain; passes {passes})",
              lambda: fr_ntt.ntt(x, L, field=F),
              lambda: fr_ntt.ntt_plain(x, L, field=F), 5, 0, 64 * m, prods),
        _hold(f"fr_ntt Fr381 inverse 2^{L}",
              lambda: fr_ntt.ntt(x, L, inverse=True, field=F),
              lambda: fr_ntt.ntt_plain(x, L, inverse=True, field=F), 5, 0,
              64 * m, prods),
        _hold(f"fr Fr381 coset round trip 2^{L} (to_coset, from_coset)",
              lambda: fr_ntt.from_coset(fr_ntt.to_coset(x, L, field=F), L,
                                        field=F),
              lambda: fr_ntt.from_coset_plain(
                  fr_ntt.to_coset_plain(x, L, field=F), L, field=F), 5, 0,
              64 * m, 3 * prods + 2 * m * IMAD_BN254)]
    del x
    return cases


def main() -> int:
    t_start = time.perf_counter()
    os.environ.setdefault("EIGEN_ZKVM_SYNC", "1")
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "eigen_zkvm_tpu_torch")):
        return _fail(f"the port's package is not beside {__file__}")
    sys.path.insert(0, ROOT)
    from eigen_zkvm_tpu_torch import bench_zkvm
    from eigen_zkvm_tpu_torch.zkvm import guest_evm_c, guests_llvm
    fixtures = [bench_zkvm.GUEST, guest_evm_c.TOKEN_ELF,
                os.path.join(ROOT, "eigen_zkvm_tpu_torch", "data", "guests",
                             "transfer_state.json")] + [
        guests_llvm.fixture_path(n) for n in sorted(guests_llvm.GUESTS)]
    missing = [f for f in fixtures if not os.path.isfile(f)]
    if missing:
        return _fail(f"a guest fixture is missing: {missing}")
    import numpy as np

    from eigen_zkvm_tpu_torch import bench_chain, kernels
    from eigen_zkvm_tpu_torch.stark.prove import stark_prove
    from eigen_zkvm_tpu_torch.utils.devices import (card_line, cuda_device,
                                                    describe)
    from eigen_zkvm_tpu_torch.utils.profiler import Prof

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = cuda_device(0)
    report = {"card": card, "device": describe(dev),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # 2. build: one nvcc job a source, all started together; each job's
    # seconds (to its end) and ptxas report, slowest first, then the total
    info = kernels.build(force=True)
    kernels.library()
    report["build_s"] = info["seconds"]
    report["build_jobs"] = [{k: j[k] for k in ("source", "seconds")}
                            for j in info["jobs"]]
    for j in info["jobs"]:
        print(f"  nvcc {j['source']}: {j['seconds']:.2f} s", flush=True)
        for line in j["ptxas"]:
            print(f"    ptxas: {line}")
    print(f"build: {info['seconds']:.2f} s (nvcc, sm_90a, "
          f"{len(info['compiled'])} sources; the slowest job "
          f"{info['jobs'][0]['source']} {info['jobs'][0]['seconds']:.2f} s)",
          flush=True)

    # 3. the field primitives against Python integers, the measured IMAD
    # rate, the kernels against their plain versions
    from eigen_zkvm_tpu_torch import kernel_probe
    from eigen_zkvm_tpu_torch.kernels import gl_check

    bad = gl_check.failures(dev)
    report["gl_check_failures"] = bad
    print(f"field primitives (csrc/gl.cuh) on edge and random operands: "
          f"{len(bad)} mismatches")
    if bad:
        return _fail("a device field primitive disagrees with Python "
                     "integers: " + "; ".join(bad[:4]))
    rate = kernel_probe.imad_issue(dev)
    report["imad_wide"] = rate
    print(f"IMAD.WIDE.U32 measured: {rate['imads_per_clock_per_sm']:.2f} a "
          f"clock an SM inside a loop that issues "
          f"{rate['instructions_per_clock_per_sm']:.2f} integer instructions "
          f"a clock an SM at {rate['clock_ghz']:.3f} GHz; the bounds assume "
          f"64 IMADs a clock an SM at 1.98 GHz")
    rng = np.random.default_rng(2024)
    cases = _check_kernels(dev, rng)
    from eigen_zkvm_tpu_torch import bench_groth16
    from eigen_zkvm_tpu_torch.kernels import bn254_check

    bad = bn254_check.failures(dev)
    report["bn254_check_failures"] = bad
    print(f"field primitives (csrc/bn254.cuh: Fq, Fr, Fq2) on edge and "
          f"random operands: {len(bad)} mismatches")
    if bad:
        return _fail("a BN254 device field primitive disagrees with Python "
                     "ints: " + "; ".join(bad[:4]))
    cases.update(_check_groth16_kernels(dev, rng))
    if any(c["err"] != 0.0 for cs in cases.values() for c in cs):
        return _fail("a kernel disagrees with its plain version")

    # 4. the main path: the port's file-based stark_prove, self-verifying
    chain_dir = tempfile.TemporaryDirectory()   # phase 16 reuses its files
    tmp = chain_dir.name
    files = bench_chain.write_chain_files(tmp, NBITS, WIDTH, QUERIES)
    zkin = os.path.join(tmp, "proof.json")
    prof = Prof("stark_gen", dev, on=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        stark_prove(files["stark_struct"], files["pil"], files["const"],
                    files["cm"], zkin_out=zkin, device=dev, prof=prof)
    except RuntimeError as e:
        return _fail(f"the port's prove failed: {e}")
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = kernels.counts()
    with open(zkin, "rb") as f:
        proof_json = f.read()
    peak = torch.cuda.max_memory_allocated(dev)
    t_gen = sum(sec for st, sec in prof.stages if st != "load + setup")
    digest = hashlib.sha256(proof_json).hexdigest()
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    print(f"main path: stark_prove on cuda, chain AIR 2^{NBITS} x {WIDTH}")
    for stage, sec in prof.stages:
        print(f"  {stage}: {sec:.3f} s")
    print(f"  stark_gen {t_gen:.3f} s; load + setup + verify "
          f"{t_total - t_gen:.3f} s; total {t_total:.3f} s; peak device "
          f"memory {peak / 2**30:.3f} GiB; launches {launches}")
    print(f"  proof JSON {len(proof_json)} bytes, sha256 {digest}; equal to "
          f"the host engine's: {digest == HOST_PROOF_SHA256}; JAX or JAX-"
          f"package modules loaded: {foreign}")
    report.update(prove_s=t_total, stark_gen_s=t_gen, stages=prof.stages,
                  peak_bytes=peak, launches=launches, verified=True,
                  proof_bytes=len(proof_json), proof_sha256=digest,
                  proof_identical=digest == HOST_PROOF_SHA256,
                  foreign_modules=foreign)
    gl_kernels = (kernels.NTT, kernels.POSEIDON)
    if any(launches[k.name] == 0 for k in gl_kernels):
        return _fail(f"a kernel of the main path never launched: {launches}")
    if digest != HOST_PROOF_SHA256:
        return _fail("the port's proof differs from the host engine's")

    # 5. Groth16 at 2^18 through the api entry points
    t0 = time.perf_counter()
    circ = bench_groth16.synthetic(G16_CONSTRAINTS, 2, G16_SEED)
    report["groth16_circuit_s"] = time.perf_counter() - t0
    g16, pk, vk = _groth16(dev, circ)
    print(f"groth16: {G16_CONSTRAINTS} constraints, {g16['n_vars']} wires, "
          f"domain 2^{g16['domain'].bit_length() - 1}; setup "
          f"{g16['setup_s']:.3f} s, prove {g16['prove_s']:.3f} s, verify "
          f"{g16['verify_s']:.3f} s ({g16['verified']}); peak device memory "
          f"{g16['peak_bytes'] / 2**30:.3f} GiB; launches {g16['launches']}")
    for stage, sec in g16["setup_stages"] + g16["stages"]:
        print(f"  {stage}: {sec:.3f} s")
    print(f"  proof sha256 {g16['proof_sha256']}; equal to the host "
          f"engine's: {g16['proof_sha256'] == GROTH16_HOST_SHA256}")
    report["groth16"] = g16
    g16_kernels = (kernels.MSM, kernels.EC_BATCH, kernels.FR_NTT,
                   kernels.R1CS)
    for k in g16_kernels:
        launches[k.name] = g16["launches"][k.name]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if not g16["verified"]:
        return _fail("the port's Groth16 proof does not verify")
    if any(launches[k.name] == 0 for k in gl_kernels + g16_kernels):
        return _fail(f"a kernel of its path never launched: {launches}")
    if g16["proof_sha256"] != GROTH16_HOST_SHA256:
        return _fail("the port's Groth16 proof differs from the host "
                     "engine's")
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")
    del circ, pk, vk

    # 6. the command line on its own 2^16 circuit: files, prove, verify,
    # render
    t0 = time.perf_counter()
    from eigen_zkvm_tpu_torch.groth16 import api

    circ = bench_groth16.synthetic(CLI_CONSTRAINTS, 2, G16_SEED)
    pk, vk = api.groth16_setup_inplace("bn128", circ,
                                       rng=bench_groth16.seeded(G16_SEED),
                                       device=dev)
    report["cli_circuit_setup_s"] = time.perf_counter() - t0
    c6 = _cli_groth16(dev, circ, vk, pk)
    report["cli_groth16"] = c6
    report["cli_groth16_s"] = time.perf_counter() - t0
    del circ, pk, vk
    stages = dict(c6["stages"])
    prove_s = sum(t for k, t in c6["stages"] if not k.startswith("load"))
    print(f"cli groth16 ({report['cli_groth16_s']:.1f} s): .r1cs written "
          f"{c6['write_r1cs_s']:.2f} s ({c6['bytes']['circuit.r1cs']} "
          f"bytes), "
          f".wtns written {c6['write_wtns_s']:.2f} s, key file saved "
          f"{c6['save_pk_s']:.2f} s ({c6['bytes']['pk.bin']} bytes); "
          f"groth16_prove {c6['prove_s']:.2f} s: .r1cs load "
          f"{stages['load r1cs']:.2f} s, .wtns load "
          f"{stages['load witness']:.2f} s, key load {stages['load pk']:.2f} "
          f"s, prove {prove_s:.2f} s; "
          f"groth16_verify {c6['verify_s']:.2f} s, generate_verifier "
          f"{c6['render_s']:.3f} s (the JAX package's text: "
          f"{c6['render_matches']}); toy setup, prove, verify "
          f"{c6['toy_s']:.2f} s; exit codes {c6['rcs']}; launches "
          f"{c6['launches']}", flush=True)
    for stage, sec in c6["stages"]:
        print(f"  {stage}: {sec:.3f} s")
    if any(rc != 0 for rc in c6["rcs"].values()) or not c6["render_matches"]:
        return _fail("a command of the port's CLI failed on its circuit")
    if c6["launches"][kernels.R1CS.name] != 1 or any(
            c6["launches"][k.name] == 0 for k in
            (kernels.MSM, kernels.FR_NTT)):
        return _fail(f"the CLI's prove did not run its kernels: "
                     f"{c6['launches']}")

    # 7. the AIRs with plookup, permutation and connection arguments
    t0 = time.perf_counter()
    print("argument AIRs through the CLI's stark_prove and stark_verify:")
    arg = _arg_airs(dev)
    report["arg_airs"] = arg
    report["arg_airs_s"] = time.perf_counter() - t0
    print(f"argument AIRs: {report['arg_airs_s']:.1f} s")
    if not all(a["ok"] for a in arg):
        return _fail("an argument AIR's proof differs from the host "
                     "engine's, was rejected, or launched no kernel")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 8. zkVM chunk proving: the ecrecover guest's chunks 0 and 1, MEMWALK
    t0 = time.perf_counter()
    print("zkvm: the ecrecover guest's chunks on the card through zkvm/:")
    try:
        z, zk_state = _zkvm(dev)
    except RuntimeError as e:
        return _fail(f"the zkVM phase failed: {e}")
    report["zkvm"] = z
    for name, more in _check_zkvm_kernels(dev, rng).items():
        cases[name] = cases[name] + more
    report["zkvm_s"] = time.perf_counter() - t0
    print(f"zkvm: {report['zkvm_s']:.1f} s; peak device memory "
          f"{z['peak_bytes'] / 2**30:.3f} GiB; chain holds "
          f"{z['chain_holds']}")
    gl_names = (kernels.NTT.name, kernels.POSEIDON.name)
    if (z["cycles"], z["n_chunks"]) != (15_642_943, 239):
        return _fail(f"the guest ran {z['cycles']} cycles in "
                     f"{z['n_chunks']} chunks")
    if not (z["chain_holds"] and all(r["digests_hold"] and r["sha256_ok"]
                                     for r in z["chunks"])):
        return _fail("a zkVM chunk's proof differs from the host engine's, "
                     "or its digests or the chain do not hold")
    if any(r["launches"][n] == 0 for r in z["chunks"] for n in gl_names) \
            or any(z["memwalk"]["launches"][n] == 0 for n in gl_names):
        return _fail("a zkVM prove did not launch the NTT and Poseidon")
    if z["memwalk"]["chunks"] < 2 or not z["memwalk"]["sum_ok"]:
        return _fail("the MEMWALK chain is short or its result is wrong")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 9. big-field eSTARK proves: BN128 and BLS12381 trees on the card
    t0 = time.perf_counter()
    print("bigfield: the final layer's shape through the CLI on the card:")
    big = _bigfield(dev)
    report["bigfield"] = big
    launches[kernels.POSEIDON_FR.name] = sum(
        r["launches"][kernels.POSEIDON_FR.name] for r in big)
    cases.update(_check_bigfield_kernels(dev, rng))
    report["bigfield_split"] = _bigfield_split(dev)
    report["bigfield_s"] = time.perf_counter() - t0
    print(f"bigfield: {report['bigfield_s']:.1f} s")
    if not all(r["ok"] for r in big):
        return _fail("a big-field proof differs from the host engine's, was "
                     "rejected, or launched no NTT or Poseidon-Fr kernel")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 10. the GL recursion layers over phase 8's chunks
    t0 = time.perf_counter()
    print("recursion: c12, recursive1 and the chained aggregation of phase "
          "8's chunks on the card:")
    from eigen_zkvm_tpu_torch import bench_circom

    layers: dict = {}   # what phase 12 renders of phases 10 and 11
    keep_layer = bench_circom.layer_keeper(layers)
    try:
        rec, agg = _recursion(dev, zk_state, keep_layer)
    except (RuntimeError, AssertionError) as e:
        return _fail(f"the recursion phase failed: {e!r}")
    del zk_state
    report["recursion"] = rec
    r1 = next(r for r in rec["layers"] if r["layer"].startswith("recursive1"))
    for name, more in _check_recursion_kernels(dev, rng, r1).items():
        cases[name] = cases[name] + more
    report["recursion_s"] = time.perf_counter() - t0
    print(f"recursion: {report['recursion_s']:.1f} s; layers "
          + ", ".join(f"{r['layer']} {r['wall_s']:.1f} s" for r in
                      rec["layers"])
          + f"; super-chunk publics hold {rec['super_publics_hold']}")
    if not all(r["sha256_ok"] for r in rec["layers"]):
        return _fail("a recursion layer's proof differs from the host "
                     "engine's")
    if not rec["super_publics_hold"]:
        return _fail("the aggregated proof's publics are not the "
                     "super-chunk's")
    if any(r["launches"][n] == 0 for r in rec["layers"] for n in gl_names):
        return _fail("a recursion layer did not launch the NTT and "
                     "Poseidon")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 11. the final BN128 layer and the Groth16 wrap of phase 10's proof
    t0 = time.perf_counter()
    print("wrap: the final BN128 layer and the Groth16 wrap of phase 10's "
          "aggregated proof on the card:")
    try:
        w11, final, wrap = _wrap(dev, agg, keep_layer)
    except (RuntimeError, AssertionError) as e:
        return _fail(f"the wrap phase failed: {e!r}")
    del agg
    report["wrap"] = w11
    t1 = time.perf_counter()
    for name, more in _check_wrap_kernels(dev, rng, final, wrap).items():
        if name in (kernels.NTT.name,):
            cases[name] = cases[name] + more
        else:
            cases[name] = more + cases.get(name, [])
    report["wrap_shapes_s"] = time.perf_counter() - t1
    del wrap
    report["wrap_s"] = time.perf_counter() - t0
    w = w11["wrap"]
    print(f"wrap: {report['wrap_s']:.1f} s (the kernels at its shapes "
          f"{report['wrap_shapes_s']:.1f} s)", flush=True)
    if any(v == 4 for v in final["widths"].values()):
        return _fail(f"a section of the final layer is 4 wide: "
                     f"{final['widths']}")
    if not (w["verified"] and w["tampered_rejected"]
            and w["publics_hash_ok"]):
        return _fail("the wrap's Groth16 proof does not verify, a changed "
                     "public verifies, or its public is not the publics "
                     "hash")
    if not all(w["sha256_ok"].values()) \
            or w["constraints"] != WRAP_CONSTRAINTS:
        return _fail("the final layer's zkin, the wrap's circuit, proof or "
                     "verifier differ from the host engine's")
    if any(final["launches"][k.name] == 0
           for k in (kernels.NTT, kernels.POSEIDON_FR)) \
            or w["by_step"]["setup"][kernels.EC_BATCH.name] == 0 \
            or any(w["by_step"]["prove"][k.name] == 0 for k in (
                kernels.MSM, kernels.FR_NTT, kernels.R1CS)):
        return _fail(f"the final layer or the wrap did not launch its "
                     f"kernels: {final['launches']}, {w['by_step']}")
    for k in g16_kernels:
        launches[k.name] = w["launches"][k.name]
    launches[kernels.POSEIDON_FR.name] = \
        final["launches"][kernels.POSEIDON_FR.name]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 12. circom: the layers' verifiers rendered, compiled circuits proved
    t0 = time.perf_counter()
    print("circom: the verifiers of phases 10 and 11 rendered; GLMulChain "
          "through compile and Groth16, GLSquareChain through compile and "
          "compressor12, on the card:")
    try:
        cir, circ, pk = _circom(dev, layers)
    except (RuntimeError, AssertionError) as e:
        return _fail(f"the circom phase failed: {e!r}")
    del layers
    report["circom"] = cir
    cases[kernels.R1CS.name] = cases[kernels.R1CS.name] + \
        _check_circom_kernels(dev, circ, pk)[kernels.R1CS.name]
    del circ, pk
    report["circom_s"] = time.perf_counter() - t0
    g, c = cir["groth16"], cir["compressor"]
    print(f"circom: {report['circom_s']:.1f} s (the routes "
          f"{cir['routes_s']:.1f} s); GLMulChain verified {g['verified']}, "
          f"a changed public rejected {g['tampered_rejected']}; the digests "
          f"equal the JAX package's: {cir['sha256_ok']}", flush=True)
    if not all(cir["sha256_ok"].values()):
        return _fail("a render, a compiled circuit's file, its proof or a "
                     "zkin differs from the JAX package's")
    if not (g["verified"] and g["tampered_rejected"]):
        return _fail("the compiled circuit's Groth16 proof does not verify, "
                     "or a changed public verifies")
    if g["launches"]["setup"][kernels.EC_BATCH.name] == 0 or any(
            g["launches"]["prove"][k.name] == 0 for k in (
                kernels.MSM, kernels.FR_NTT, kernels.R1CS)) or any(
            c["launches"][k.name] == 0 for k in gl_kernels):
        return _fail(f"a circom route did not launch its kernels: "
                     f"{g['launches']}, {c['launches']}")
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 13. the zkVM guests: the committed ELFs run, the EVM transfer proved
    from eigen_zkvm_tpu_torch import bench_guests

    t0 = time.perf_counter()
    print("guests: the committed guest ELFs on the native executor; the EVM "
          "transfer guest proved on the card through evm.prove_state_test:")
    try:
        gst = _guests(dev)
    except (RuntimeError, AssertionError) as e:
        return _fail(f"the guests phase failed: {e!r}")
    report["guests"] = gst
    report["guests_s"] = time.perf_counter() - t0
    setup_s = sum(sec for _, sec in gst["setup"])
    print(f"  transfer: setup {setup_s:.3f} s ("
          + ", ".join(f"{st} {sec:.3f}" for st, sec in gst["setup"]) + ")",
          flush=True)
    for k, stages in enumerate(gst["stages"]):
        print(f"  chunk {k}: {sum(sec for _, sec in stages):.3f} s: "
              + ", ".join(f"{st} {sec:.3f}" for st, sec in stages)
              + f"; zkin sha256 {gst['zkin_sha256'][k][:16]}...",
              flush=True)
    print(f"guests: {report['guests_s']:.1f} s (the prove "
          f"{gst['prove_s']:.1f} s); {gst['n_chunks']} chunks of "
          f"2^{bench_guests.NBITS} rows, status {gst['status']}, gas "
          f"{gst['gas_used']}; chain holds {gst['chain_holds']}, the "
          f"post-state's accounts hold {gst['post_ok']}; the zkins equal "
          f"the host engine's: "
          f"{gst['sha256_ok']}; launches {gst['launches']}", flush=True)
    if not all(r["ok"] for r in gst["elfs"]):
        return _fail("a committed guest ELF did not run to its oracle")
    if gst["n_chunks"] != 2 or not (gst["chain_holds"] and gst["post_ok"]):
        return _fail("the transfer guest's chunks do not chain, or its "
                     "post-state does not hold")
    if not gst["sha256_ok"]:
        return _fail("a transfer chunk's proof differs from the host "
                     "engine's")
    if any(gst["launches"][n] == 0 for n in gl_names):
        return _fail(f"the transfer guest's prove did not launch the NTT "
                     f"and Poseidon: {gst['launches']}")
    for name, more in _check_guests_kernels(dev, rng, gst["width"]).items():
        cases[name] = cases[name] + more
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 14. BLS12-381 Groth16: the field row, the prove, the kernels' holds
    t0 = time.perf_counter()
    print("bls: BLS12-381 Groth16 on the card (its Fq and Fq2 in "
          "csrc/bn254.cuh, K1-K4 at its fields):", flush=True)
    bad = bn254_check.failures(dev, fields=("Fq381",))
    report["bls_check_failures"] = bad
    print(f"  field primitives (csrc/bn254.cuh row 3: Fq381, its Fq2) on "
          f"edge and random operands: {len(bad)} mismatches "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if bad:
        return _fail("a BLS12-381 device field primitive disagrees with "
                     "Python ints: " + "; ".join(bad[:4]))
    try:
        b14, circ, pk = _bls(dev)
    except (RuntimeError, AssertionError, ValueError) as e:
        return _fail(f"the BLS12-381 Groth16 phase failed: {e!r}")
    report["bls"] = b14
    print(f"  groth16 BLS12-381: {G16_CONSTRAINTS} constraints, "
          f"{b14['n_vars']} wires, domain 2^{b14['domain'].bit_length() - 1}"
          f"; circuit {b14['circuit_s']:.3f} s, setup {b14['setup_s']:.3f} "
          f"s, prove {b14['prove_s']:.3f} s, verify {b14['verify_s']:.3f} s "
          f"({b14['verified']}), a changed public rejected "
          f"{b14['tampered_rejected']} ({b14['changed_verify_s']:.3f} s); "
          f"peak device memory {b14['peak_bytes'] / 2**30:.3f} GiB; "
          f"launches {b14['launches']}", flush=True)
    for stage, sec in b14["setup_stages"] + b14["stages"]:
        print(f"    {stage}: {sec:.3f} s")
    print(f"  proof sha256 {b14['proof_sha256']}; equal to the host "
          f"engine's: {b14['proof_sha256'] == BLS_GROTH16_HOST_SHA256}",
          flush=True)
    bls_kernels = (kernels.MSM_BLS, kernels.EC_BATCH_BLS, kernels.FR_NTT_BLS,
                   kernels.R1CS_BLS)
    for k in bls_kernels:
        launches[k.name] = b14["launches"][k.name]
    if not (b14["verified"] and b14["tampered_rejected"]):
        return _fail("the BLS12-381 Groth16 proof does not verify, or a "
                     "changed public verifies")
    if any(launches[k.name] == 0 for k in bls_kernels):
        return _fail(f"a BLS12-381 kernel never launched: {b14['launches']}")
    if b14["proof_sha256"] != BLS_GROTH16_HOST_SHA256:
        return _fail("the port's BLS12-381 Groth16 proof differs from the "
                     "host engine's")
    t1 = time.perf_counter()
    cases.update(_check_bls_kernels(dev, rng, circ, pk))
    del circ, pk
    report["bls_holds_s"] = time.perf_counter() - t1
    report["bls_s"] = time.perf_counter() - t0
    print(f"bls: {report['bls_s']:.1f} s (the holds "
          f"{report['bls_holds_s']:.1f} s)", flush=True)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 15. the gnark bridge's part: a BN254 proof's verifier over BLS12-381
    t0 = time.perf_counter()
    print("bridge: bench_bridge.bridge_part of a BN254 Groth16 proof, "
          "proved with BLS12-381 Groth16 on the card:", flush=True)
    try:
        b15 = _bridge(dev)
    except (RuntimeError, AssertionError, ValueError) as e:
        return _fail(f"the bridge phase failed: {e!r}")
    report["bridge"] = b15
    print(f"  bridge_part: {b15['constraints']} constraints, "
          f"{b15['n_vars']} wires, domain 2^{b15['domain'].bit_length() - 1}"
          f"; inner proof {b15['inner_s']:.3f} s, circuit "
          f"{b15['build_s']:.3f} s, setup {b15['setup_s']:.3f} s, prove "
          f"{b15['prove_s']:.3f} s, verify {b15['verify_s']:.3f} s "
          f"({b15['verified']}), a changed public rejected "
          f"{b15['tampered_rejected']} ({b15['changed_verify_s']:.3f} s); "
          f"peak device memory {b15['peak_bytes'] / 2**30:.3f} GiB; "
          f"launches {b15['launches']}", flush=True)
    for stage, sec in b15["setup_stages"] + b15["stages"]:
        print(f"    {stage}: {sec:.3f} s")
    print(f"  proof sha256 {b15['proof_sha256']}; equal to the host "
          f"engine's: {b15['proof_sha256'] == BRIDGE_PART_SHA256}",
          flush=True)
    if not (b15["verified"] and b15["tampered_rejected"]):
        return _fail("the bridge part's proof does not verify, or a changed "
                     "public verifies")
    if any(b15["launches"][k.name] == 0 for k in bls_kernels):
        return _fail(f"a BLS12-381 kernel never launched in the bridge "
                     f"phase: {b15['launches']}")
    if b15["constraints"] != BRIDGE_PART_CONSTRAINTS \
            or b15["proof_sha256"] != BRIDGE_PART_SHA256:
        return _fail("the bridge part's circuit or proof differs from the "
                     "host engine's")
    t1 = time.perf_counter()
    cases[kernels.FR_NTT_BLS.name] = cases[kernels.FR_NTT_BLS.name] + \
        _check_bridge_kernels(dev)
    report["bridge_holds_s"] = time.perf_counter() - t1
    report["bridge_s"] = time.perf_counter() - t0
    print(f"bridge: {report['bridge_s']:.1f} s (the holds "
          f"{report['bridge_holds_s']:.1f} s)", flush=True)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "eigen_zkvm_tpu"))
    report["foreign_modules"] = foreign
    if foreign:
        return _fail(f"JAX or the JAX package was loaded: {foreign[:8]}")

    # 16. sharded: phase 4's chain AIR over four gloo ranks on this card
    print(f"sharded: phase 4's files through sharded_prove on {SHARDS} gloo "
          f"ranks on this card, then make_sharded_commit on a "
          f"{COMMIT_GRID} grid:", flush=True)
    from eigen_zkvm_tpu_torch import bench_sharded

    t0 = time.perf_counter()
    try:
        shard_cases = _check_sharded_kernels(dev, rng)
        s16 = _sharded(dev, files)
    except (RuntimeError, ValueError) as e:   # launch.RankError included
        return _fail(f"the sharded phase failed: {e!r}")
    chain_dir.cleanup()
    for name, cs in shard_cases.items():
        cases[name] = cases[name] + cs
    sp = s16["prove"]
    report["sharded"] = s16
    report["sharded_s"] = time.perf_counter() - t0
    print(f"  ranks up {s16['pool_up_s']:.1f} s (the single-device commit "
          f"reference {s16['reference_s']:.1f} s of it)", flush=True)
    bench_sharded.print_config(NBITS, WIDTH, sp)
    print(f"  proof sha256 equal to the host engine's: "
          f"{sp['sha256'] == [HOST_PROOF_SHA256]}")
    print(f"  make_sharded_commit {COMMIT_GRID}, {COMMIT_BATCH} traces of "
          f"2^{NBITS} x {WIDTH}: {s16['commit_s']:.3f} s with the task's "
          f"queueing; roots equal to the single-device extend_and_merkelize "
          f"roots: {s16['commit_roots_equal']}; collectives (rank 0): "
          f"{bench_sharded.collectives_line(s16['commit_collectives'])}"
          f"; peak device memory by rank, GiB: "
          + ", ".join(f"{p / 2**30:.3f}" for p in s16["commit_peak_bytes"]))
    print(f"sharded: {report['sharded_s']:.1f} s", flush=True)
    if sp["sha256"] != [HOST_PROOF_SHA256] or not sp["verified"]:
        return _fail("the sharded proof differs from the host engine's or "
                     "does not verify")
    if not s16["commit_roots_equal"]:
        return _fail("the sharded commit's roots differ from the "
                     "single-device roots")
    if any(lc[k.name] == 0 for lc in sp["launches"] + s16["commit_launches"]
           for k in gl_kernels):
        return _fail(f"a GL kernel never launched on a rank of the sharded "
                     f"phase: {sp['launches']}, {s16['commit_launches']}")

    checks = [dict(cs[0], name=name, err=max(c["err"] for c in cs),
                   cases=cs) for name, cs in cases.items()]
    report["kernel_checks"] = checks
    if any(c["err"] != 0.0 for c in checks):
        return _fail("a kernel disagrees with its plain version at the "
                     "zkVM path's, the big-field proves', the recursion "
                     "layers', the wrap's, the compiled circuit's, the "
                     "BLS12-381 phase's, the bridge's or the sharded "
                     "prove's shapes")

    report["smoke_s"] = time.perf_counter() - t_start
    print(f"smoke: {report['smoke_s']:.1f} s, kernel build included")
    print(f"report: {json.dumps(report)}")
    by_name = {c["name"]: c for c in checks}
    kernel_lines = [{"name": k.name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[k.name],
                     "max_abs_err": by_name[k.name]["err"],
                     "ms": by_name[k.name]["ms"],
                     "plain_ms": by_name[k.name]["plain_ms"],
                     "bound_ms": by_name[k.name]["bound_ms"],
                     "bound_by": by_name[k.name]["bound_by"],
                     "library_ms": None,
                     "cases": [{key: c[key] for key in (
                         "label", "ms", "plain_ms", "bound_ms", "bound_by",
                         "err")} for c in by_name[k.name]["cases"]]}
                    for k in kernels.KERNELS]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernel_lines}))
    print(json.dumps({"ok": True, "device": describe(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
