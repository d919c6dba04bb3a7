"""The port stands alone: it imports neither jax nor the JAX package,
and it never runs on the CPU unless the caller asks for it."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "src"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.strassen_fused\n"
        "import repro_torch.core.schedule\n"
        "import repro_torch.kernels._launch, repro_torch.kernels.matmul\n"
        "import repro_torch.kernels.syrk, repro_torch.kernels.combine\n"
        "import repro_torch.kernels.transpose\n"
        "from repro_torch.kernels.ops import (matmul, syrk, syrk_packed,\n"
        "    strassen_combine, transpose, kernel_base_matmul,\n"
        "    kernel_base_syrk)\n"
        "from repro_torch.kernels.ops import (aat_fused, aat_fused_packed,\n"
        "    rank_k_update, matmul_fused)\n"
        "from repro_torch.kernels.strassen_fused import (fused_aat,\n"
        "    fused_aat_packed, fused_rank_k_update, fused_matmul)\n"
        "from repro_torch.core import strassen_matmul\n"
        "import repro_torch.kernels.flash_attention\n"
        "from repro_torch.kernels.ops import flash_mha\n"
        "from repro_torch.kernels.ref import flash_attention_ref\n"
        "import repro_torch.configs.base, repro_torch.configs.qwen2_5_3b\n"
        "from repro_torch.configs.registry import get_arch, reduced_arch\n"
        "import repro_torch.models.layers, repro_torch.models.blocks\n"
        "from repro_torch.models import (init_params, forward, init_cache,\n"
        "    prefill, decode_step)\n"
        "from repro_torch.models.convert import params_from_jax\n"
        "from repro_torch.runtime import ServingEngine, Request\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.gram.verify import verify_gram, default_rtol\n"
        "from repro_torch.obs.trace import get_tracer\n"
        "from repro_torch.obs.metrics import counter, get_registry\n"
        "from repro_torch.core import pack_tril, unpack_tril\n"
        "from repro_torch.checkpoint import (CheckpointManager,\n"
        "    save_pytree, load_pytree)\n"
        "from repro_torch.gram import (stream, GramStream, stream_init,\n"
        "    stream_update, stream_finalize, GramStackStream, stack_init,\n"
        "    stack_update, stack_finalize, CheckpointedGramStream)\n"
        "from repro_torch.kernels.strassen_fused import (\n"
        "    stochastic_round_bf16, _quantize)\n"
        "import repro_torch.core.cost_model, repro_torch.core.distributed\n"
        "import repro_torch.launch.mesh, repro_torch.runtime.faults\n"
        "import repro_torch.gram.autotune\n"
        "from repro_torch.core import (distributed_gram, gram_ring,\n"
        "    gram_bfs25d, cost_model, plan_ata, schedule)\n"
        "from repro_torch.gram import (autotune_bucket,\n"
        "    resolve_block_defaults, distributed_update, update_sharded)\n"
        "from repro_torch.runtime import faults\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# `repro_torch` starts with `repro`: only `repro` followed by `.`, a space,
# a comma or the end of the line names the JAX package.
_BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax\b|jaxlib\b|repro\s*(\.|,|$|\s+as\b))"
    r"|from\s+(jax\b|jaxlib\b|repro\s*(\.|\s+import\b)))")


def test_source_scan_finds_no_jax_or_reference_import():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 5
    for path in files:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not _BAD_IMPORT.search(line), f"{path}:{i}: {line}"
    for good, bad in (("import repro_torch", "import repro"),
                      ("from repro_torch.core import ata",
                       "from repro.core import ata"),
                      ("from repro_torch import core",
                       "from repro import core")):
        assert not _BAD_IMPORT.search(good) and _BAD_IMPORT.search(bad)


def test_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    from repro_torch.core import ata, ata_full, strassen_matmul
    from repro_torch.kernels import ops, strassen_fused
    a = torch.ones(8, 8)
    for fn in (ata, ata_full, ops.ata_fused, ops.ata_fused_packed,
               strassen_fused.fused_ata, strassen_fused.fused_ata_packed,
               ops.aat_fused, ops.aat_fused_packed, strassen_fused.fused_aat,
               strassen_fused.fused_aat_packed, ops.syrk, ops.syrk_packed,
               ops.transpose):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ata(a, gram_of="rows")
    stack = torch.ones(24, 8)
    for fn, args in ((strassen_matmul, (a, a)), (ops.symm_matmul, (a, stack)),
                     (strassen_fused.fused_symm_matmul, (a, stack)),
                     (ops.rank_k_update, (stack, a)),
                     (strassen_fused.fused_rank_k_update, (stack, a)),
                     (ops.matmul_fused, (a, a)),
                     (strassen_fused.fused_matmul, (a, a)),
                     (ops.matmul, (a, a)),
                     (ops.strassen_combine, (a,) * 7)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strassen_matmul(a, a, trans_a=True, mode="auto")


def test_serving_entry_points_refuse_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    from repro_torch.configs.registry import reduced_arch
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.convert import params_from_jax
    from repro_torch.runtime import ServingEngine
    from repro_torch.launch import serve
    q = torch.ones(1, 16, 2, 16)
    cfg = reduced_arch("qwen2.5-3b", num_layers=1)
    for call in (lambda: ops.flash_mha(q, q, q),
                 lambda: init_params(cfg, 0),
                 lambda: init_cache(cfg, 1, 16),
                 lambda: params_from_jax(cfg, {}),
                 lambda: serve.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    # with device="cpu" they run
    assert ops.flash_mha(q, q, q, device="cpu").shape == q.shape
    ServingEngine(cfg, params, device="cpu")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("device_type,backend,ok", [
    ("cuda", "nccl", True), ("cuda", "gloo", False),
    ("cpu", "gloo", True), ("cpu", "nccl", False),
    ("cuda", "cpu:gloo,cuda:nccl", True), ("meta", "gloo", False)])
def test_distributed_refuses_host_staging(device_type, backend, ok):
    """The distributed schemes run a CUDA tensor through NCCL and a CPU
    tensor through gloo: a CUDA tensor on a gloo group, or a CPU tensor
    on a CUDA mesh (NCCL), is refused, never staged through the host.
    The refusal is a plain check of (tensor device, group backend)."""
    from repro_torch.core.distributed import check_backend
    if ok:
        check_backend(device_type, backend)
    else:
        with pytest.raises(ValueError, match="never stage|cuda or cpu"):
            check_backend(device_type, backend)


@pytest.mark.parametrize("scheme", ["allreduce", "reducescatter", "ring",
                                    "bfs25d"])
def test_distributed_gram_refuses_a_cpu_tensor_on_a_cuda_mesh(
        monkeypatch, scheme):
    """Every scheme checks its tensor against its groups before any
    compute or collective (a one-rank mesh whose groups are NCCL's)."""
    from repro_torch.core import distributed

    class CudaMesh:
        device_type = "cuda"
        mesh_dim_names = ("rep", "data", "model")
        shape = (1, 1, 1)
        mesh = torch.zeros((1, 1, 1), dtype=torch.int)

        def get_coordinate(self):
            return (0, 0, 0)

        def get_group(self, axis):
            return f"group:{axis}"

    monkeypatch.setattr(distributed.dist, "get_backend",
                        lambda group=None: "nccl")
    with pytest.raises(ValueError, match="never stage"):
        distributed.distributed_gram(
            torch.ones(16, 8), CudaMesh(), scheme=scheme, row_axis="data",
            col_axis="model", rep_axis="rep")
