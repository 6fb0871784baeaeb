"""The port stands alone: vernemq_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package (vernemq_tpu), and chip_smoke.py refuses
to run — printing no result — without a card or without the package."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vernemq_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "vernemq_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_alone_and_chip_smoke_needs_it(tmp_path):
    """In a fresh interpreter with jax and vernemq_tpu blocked: chip_smoke.py
    alone in a directory — even where a card is reported — fails before
    printing any result; then every module of the port, and chip_smoke,
    imports."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    code = (
        "import sys, pkgutil, importlib, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vernemq_tpu'] = None\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except ModuleNotFoundError as e:\n"
        "    print('refused:', e.name)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import vernemq_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__,"
        " 'vernemq_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print('imported:', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("refused: vernemq_tpu_torch"), out.stdout
    assert '"ok"' not in out.stdout
    assert int(lines[-1].split()[-1]) >= 10


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    import torch

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_engine_kernel_libraries_bind_in_a_fresh_process():
    """The match and retained engines' ``load_kernels(KERNEL_LIBS)`` finds
    each library's ``ctypes`` binder in a process that has imported only
    that engine (a broker process starting on the card loads them at
    boot): in a fresh interpreter per engine, no binder before the import,
    each of the engine's libraries after it — the extraction kernel's from
    either engine alone."""
    libs = {}
    for engine in ("models.matcher", "retained.index"):
        code = (
            "import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from vernemq_tpu_torch.ops import _build as B\n"
            "assert not B._binders, B._binders\n"
            f"from vernemq_tpu_torch.{engine} import KERNEL_LIBS as libs\n"
            "assert all(n in B._binders for n in libs), (libs, B._binders)\n"
            "print(' '.join(sorted(libs)))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        libs[engine] = out.stdout.split()
    assert libs == {"models.matcher": ["extract", "tile_match"],
                    "retained.index": ["extract", "reverse_match"]}


@pytest.mark.parametrize("name", ["mesh", "sharded_match", "mesh_match"])
def test_multi_gpu_modules_stand_alone(name):
    """The multi-GPU modules are among the files checked above for jax and
    vernemq_tpu imports, and each imports in a fresh interpreter where
    both are blocked; the two matchers bind the kernel libraries their
    dispatch launches (the tile matcher's and the extraction's)."""
    path = ROOT / "vernemq_tpu_torch" / "parallel" / f"{name}.py"
    assert path in PORT_FILES
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['vernemq_tpu'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from vernemq_tpu_torch.ops import _build as B\n"
        f"import vernemq_tpu_torch.parallel.{name}\n"
        "want = {'tile_match', 'extract'} if %r != 'mesh' else set()\n"
        "assert want <= set(B._binders), B._binders\n" % name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
