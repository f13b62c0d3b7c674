"""Prover engine of the port: the device a prove runs on.

Port of eigen_zkvm_tpu/stark/engine.py's device-resident configuration
(commit, VM and FRI all on the accelerator).  Everything a prove computes
over the domain stays on `device`: the commits, the constraint VM, the Q
split, the openings, xDivXSubXi and the FRI fold chain.  `Engine()` takes the
current CUDA device and raises when there is none; `Engine("cpu")` is the
explicit CPU choice, which runs the same code on CPU tensors with the
kernels' plain versions.  `Engine(mesh=m)` proves on the row blocks of a
parallel/meshctx.Mesh, on that rank's device.
"""
from __future__ import annotations

import torch


class Engine:
    """Resolved engine for one prove."""

    def __init__(self, device: torch.device | str | None = None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to "
                                   "prove on the CPU")
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    def __repr__(self):
        mesh = "" if self.mesh is None else f", mesh={self.mesh}"
        return f"Engine(device={self.device}, resident=True{mesh})"
