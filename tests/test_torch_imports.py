"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``;
its entry points run on the card unless the CPU was asked for; and no
kernel wrapper falls back to its plain version on a CUDA tensor."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_no_port_file_imports_jax_or_repro():
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in _sources() for line, mod in _imports(p)
           if _forbidden(mod)]
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import json, sys\n"
        "import repro_torch.jpeg.paths, repro_torch.codecs\n"
        "import repro_torch.jpeg.corpus, repro_torch.kernels.ops\n"
        "import repro_torch.service, repro_torch.obs, repro_torch.core\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.jpeg.paths" in modules
    assert not [m for m in modules if _forbidden(m)]


def test_current_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        device.current_device()
    with device.use_device("cpu"):
        assert device.current_device() == torch.device("cpu")
        with device.use_device("cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                device.current_device()
        assert device.current_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        device.current_device()


def test_set_device_is_process_wide_and_scopes_override_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    device.set_device("cpu")
    assert device.current_device() == torch.device("cpu")
    with device.use_device("cuda"):
        with pytest.raises(RuntimeError):
            device.current_device()
    device.set_device(None)
    with pytest.raises(RuntimeError):
        device.current_device()


def test_the_default_device_is_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    assert device.current_device() == torch.device("cuda", 0)


def test_cuda_paths_without_a_card_raise_instead_of_using_the_cpu(
        monkeypatch, corpus):
    from repro_torch.codecs import get_decoder
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device, "_PROCESS_DEVICE", None)
    for name in ("cuda-batch", "cuda-fused", "torch-batch"):
        out = get_decoder(name).decode_batch([corpus.files[0]])
        assert isinstance(out[0], RuntimeError), name
        assert "no CUDA card" in str(out[0])


def test_ops_has_no_except_around_a_launch():
    """A CUDA tensor reaches its kernel or the call raises: ``ops.py``
    catches nothing, so no launch failure can turn into a plain-version
    result."""
    tree = ast.parse((PORT / "kernels" / "ops.py").read_text())
    handlers = [n.lineno for n in ast.walk(tree)
                if isinstance(n, (ast.Try, ast.ExceptHandler))]
    assert not handlers, handlers


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH="")
    env.pop("JAX_PLATFORMS", None)
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    bare = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    for run in (here, bare):
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
