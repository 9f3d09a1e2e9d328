"""The port stands alone, and rejects what it does not run.

* Every module of ``fairify_tpu_torch`` (and ``chip_smoke.py``) imports with
  ``jax`` blocked, and none imports ``jax`` or any ``fairify_tpu`` module.
* The numeric policy holds after import: no TF32 anywhere.
* Configurations outside the stage-0 slice raise ``NotImplementedError``
  naming their ROADMAP item; a CUDA entry point without CUDA raises.
"""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "fairify_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _is_forbidden(name: str) -> bool:
    return name in ("jax", "fairify_tpu") or name.startswith(("jax.", "fairify_tpu."))


def test_package_imports_with_jax_blocked():
    names = [name for name, _ in _modules()]
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        for name in {names!r}:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules if m == "fairify_tpu"
               or m.startswith("fairify_tpu.") or m == "jax" and sys.modules[m]]
        assert not bad, bad
        print("ok", len({names!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", [p for _, p in _modules()] + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_is_forbidden(n) for n in names), (path, node.lineno, names)


def test_tf32_is_off_after_import():
    from fairify_tpu_torch.utils import num

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    num.check_policy()


def _cfg(tmp_path, **kw):
    from fairify_tpu_torch.verify import presets

    return presets.get("GC").with_(result_dir=str(tmp_path), **kw)


@pytest.mark.parametrize("field,value,item", [
    ("mega_chunks", 0, "K10"),
    ("exact_certify_masks", True, "exact-certify"),
    ("inject_faults", ("launch.decode:transient:1",), "item 7"),
    ("integrity_recheck", 0.05, "item 7"),
])
def test_unported_config_raises(tmp_path, field, value, item):
    from fairify_tpu_torch.models.mlp import flagship_net
    from fairify_tpu_torch.verify import sweep

    kw = {"exact_certify_masks": False, field: value}
    with pytest.raises(NotImplementedError, match=item):
        sweep.verify_model(flagship_net(device="cpu"), _cfg(tmp_path, **kw),
                           resume=False, device="cpu")


def test_ibp_engine_and_mesh_raise(tmp_path):
    from fairify_tpu_torch.models.mlp import flagship_net
    from fairify_tpu_torch.verify import sweep
    from fairify_tpu_torch.verify.config import EngineConfig

    net = flagship_net(device="cpu")
    with pytest.raises(NotImplementedError, match="K10"):
        sweep.verify_model(net, _cfg(tmp_path, exact_certify_masks=False,
                                     engine=EngineConfig(use_crown=False)),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        sweep.verify_model(net, _cfg(tmp_path, exact_certify_masks=False),
                           mesh=object(), device="cpu")


def test_cuda_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    from fairify_tpu_torch.models.mlp import flagship_net, from_numpy
    from fairify_tpu_torch.verify import sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy([np.ones((2, 1), np.float32)], [np.zeros(1, np.float32)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.verify_model(flagship_net(device="cpu"),
                           _cfg(tmp_path, exact_certify_masks=False))


def test_pack_net_layout_and_key_bits():
    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.utils import cuda_build

    net = seeded_net((5, 4, 3, 1), seed=2, device="cpu")
    params, dims = cuda_build.pack_net(net)
    assert list(dims) == [5, 4, 3, 1]
    off = 0
    for w, b, m in zip(net.weights, net.biases, net.masks):
        for t in (w.reshape(-1), b, m):
            assert torch.equal(params[off:off + t.numel()], t)
            off += t.numel()
    assert off == params.numel()
    keys = torch.tensor([[0, 2**32 - 1], [2**31, 5]], dtype=torch.int64)
    k32 = cuda_build.u32_keys(keys)
    assert k32.dtype == torch.int32
    assert ((k32.to(torch.int64) & 0xFFFFFFFF) == keys).all()


def test_kernel_sources_are_present_and_standalone():
    from fairify_tpu_torch.utils import cuda_build

    for name in cuda_build.SOURCES:
        src = (PKG / "csrc" / f"{name}.cu").read_text()
        assert '#include "common.cuh"' in src and 'extern "C"' in src
        assert "use_fast_math" not in src
    assert "-use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
