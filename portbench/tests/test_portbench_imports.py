"""The import check: the JAX package and JAX are matched by whole
top-level name; the reference imports nothing of the port."""
import json
import subprocess
import sys
import types

import torch

from portbench import run


def test_foreign_modules_match_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib.xla", "eigen_zkvm_tpu.stark",
                 "eigen_zkvm_tpu_torch_extra", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = run.foreign_modules()
    assert "jax" in found and "jaxlib.xla" in found
    assert "eigen_zkvm_tpu.stark" in found
    assert not any(m.startswith(("eigen_zkvm_tpu_torch", "jaxtyping"))
                   for m in found)


def test_the_reference_imports_neither_the_port_nor_jax():
    code = ("import sys, json\n"
            "import portbench.reference.verify, portbench.reference.layout, "
            "portbench.trace, portbench.record, portbench.peaks\n"
            "import portbench.configs.chain_gl_2e23x8, "
            "portbench.configs.plookup_gl_2e22\n"
            "import portbench.metrics.ntt_roofline, "
            "portbench.metrics.poseidon_gl_roofline\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out))
    assert not tops & {"jax", "jaxlib", "flax", "eigen_zkvm_tpu",
                       "eigen_zkvm_tpu_torch"}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "chain_gl_2e23x8.serial", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_loaded_jax_module_withholds_the_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "chain_gl_2e23x8.serial", "--seed", "1",
                     "--seconds", "1"]) != 0
    cap = capsys.readouterr()
    assert cap.out == "" and "jax" in cap.err
