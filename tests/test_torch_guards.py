"""Guards of the port: it imports neither JAX nor the JAX package, and an
entry point asked for the card where there is none raises instead of falling
back to the CPU."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "clip_assisted_data_labeling_tpu_torch"


def _port_modules() -> list[str]:
    mods = []
    for dirpath, _dirs, files in os.walk(os.path.join(REPO, PORT)):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_no_jax():
    """Every module of the port and its CLI in a fresh interpreter: neither
    ``jax`` nor ``clip_assisted_data_labeling_tpu`` (matched as the bare name
    or with a dot — the port's own name shares that prefix) may load."""
    mods = _port_modules()
    assert f"{PORT}.pipeline.embed" in mods and len(mods) > 15
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in set(sys.modules) - before"
        " if m in ('jax', 'clip_assisted_data_labeling_tpu')"
        " or m.startswith(('jax.', 'clip_assisted_data_labeling_tpu.'))]\n"
        "print(sorted(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def _forbidden(name: str) -> bool:
    return name in ("jax", "clip_assisted_data_labeling_tpu") or name.startswith(
        ("jax.", "clip_assisted_data_labeling_tpu."))


def test_no_jax_import_statement_anywhere():
    """Every import statement of the port's sources and chip_smoke.py —
    function-level ones included, which the import test cannot reach."""
    import ast

    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, *m.split(".")) + ".py" if os.path.exists(
            os.path.join(REPO, *m.split(".")) + ".py")
        else os.path.join(REPO, *m.split("."), "__init__.py") for m in _port_modules()]
    bad = []
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(f, n) for n in names if _forbidden(n)]
    assert len(files) > 15 and not bad, bad


def test_cuda_request_without_card_raises(monkeypatch, tmp_path):
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main
    from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        CLIPImageEncoder("ViT-Test/tiny")  # default device is the card
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--root_dir", str(tmp_path), "--models_to_use", "ViT-Test/tiny"])
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_card():
    """No card: nonzero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_dedup_path_imports_no_pandas_or_matplotlib(tmp_path):
    """The card's machine lists neither: the dedup CLI, the label database
    and the plot module (matplotlib only inside a plot call) import none of
    them, and nothing of JAX."""
    code = (
        "import sys\n"
        f"from {PORT}.pipeline import dedup\n"
        f"from {PORT}.store import database\n"
        f"from {PORT}.utils import plots\n"
        f"dedup.main(['--root_dir', {str(tmp_path)!r}, '--device', 'cpu'])\n"
        f"database.LabelDatabase.load_or_create({str(tmp_path)!r}).save()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('pandas', 'matplotlib', 'jax')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_unported_cli_options_refused(tmp_path, monkeypatch, capsys):
    """The multi-host flags, once refused, carry the JAX semantics:
    ``--host_count 2`` without sidecars raises the JAX package's ValueError,
    and ``--distributed`` without a coordinator runs as one host."""
    from clip_assisted_data_labeling_tpu.pipeline.embed import main as jax_main
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main

    args = ["--root_dir", str(tmp_path), "--models_to_use", "ViT-Test/tiny"]
    with pytest.raises(ValueError, match="requires sidecars") as port_err:
        main([*args, "--device", "cpu", "--host_count", "2", "--no_sidecars"])
    with pytest.raises(ValueError) as jax_err:
        jax_main([*args, "--host_count", "2", "--no_sidecars"])
    assert str(port_err.value) == str(jax_err.value)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    stores = main([*args, "--device", "cpu", "--distributed"])
    assert stores["ViT-Test/tiny"].meta["n"] == 0
    assert "torch.distributed up: host 0/1" in capsys.readouterr().out
