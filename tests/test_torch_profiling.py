"""The port's profiling layer (`long_video_gan_tpu_torch/utils/profiling.py`)
on the CPU: CUDA kernel names by category (the port's six kernels by their
symbols among them), the op summary's totals and shares, chrome traces read
(a hand-written one) and refused (a CPU-only one from `trace`), and
`module_summary`'s parameter counts against the JAX variables' leaf sizes
(`tests/test_profiling.py` holds the JAX helpers)."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.io.convert_torch import flax_path_to_torch_key
from long_video_gan_tpu.models import generator_lres as jax_lres
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch.models import generator_lres, generator_sres
from long_video_gan_tpu_torch.utils import profiling
from test_torch_generators import LRES_KW, SRES_KW


@pytest.mark.parametrize("name, category", [
    # The port's kernels, as CUPTI names them (csrc/*.cu).
    ("filtered_lrelu_fwd_tc_kernel(__nv_bfloat16 const*, __nv_bfloat16*, Params)",
     "K1 filtered_lrelu fwd"),
    ("filtered_lrelu_fwd_kernel(float const*, float*, Params)", "K1 filtered_lrelu fwd"),
    ("filtered_lrelu_bwd_tc_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*)",
     "K2 filtered_lrelu bwd"),
    ("filtered_lrelu_bwd_kernel(float const*, float const*, float*)", "K2 filtered_lrelu bwd"),
    ("(anonymous namespace)::flrelu_f32_fwd_kernel(float const*, float*, float const*, "
     "(anonymous namespace)::Geometry)", "K1f32 filtered_lrelu fwd"),
    ("(anonymous namespace)::flrelu_f32_bwd_kernel(float const*, float const*, float*, "
     "float const*, (anonymous namespace)::Geometry)", "K2f32 filtered_lrelu bwd"),
    ("void filtered_lrelu_fused_fwd_tc_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
     "K3a filtered_lrelu fused fwd"),
    ("void filtered_lrelu_fused_bwd_tc_kernel<float>(float const*, float const*)",
     "K3b filtered_lrelu fused bwd"),
    ("void filtered_lrelu_exact_tc_kernel<float>(float const*, float*)",
     "K4 filtered_lrelu exact"),
    ("void filtered_lrelu_polyphase_tc_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
     "K5 filtered_lrelu polyphase"),
    # Library kernels by family.
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "conv (cuDNN/CUTLASS)"),
    ("sm90_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nhwckrsc_nchw",
     "conv (cuDNN/CUTLASS)"),
    ("cutlass__5x_cudnn::Kernel<cutlass_tensorop_s1688wgrad_optimized_tf32_64x64_16x10>",
     "conv (cuDNN/CUTLASS)"),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false>",
     "conv (cuDNN/CUTLASS)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1",
     "gemm (cuBLAS/CUTLASS)"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float>",
     "gemm (cuBLAS/CUTLASS)"),
    ("void at::native::conv_depthwise2d_forward_kernel<3, float, int>", "depthwise conv"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MeanOps<float>>>",
     "reduce"),
    ("void cudnn::ops::nchwToNhwcKernel<float, float, float, false, true>",
     "relayout (transpose/copy/cat)"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 4>",
     "relayout (transpose/copy/cat)"),
    ("void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>",
     "relayout (transpose/copy/cat)"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather/scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 4>", "gather/scatter"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<3>, LerpFunctor<float>>",
     "optimizer"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "nccl"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy/memset"),
    ("Memset (Device)", "memcpy/memset"),
    ("void at::cuda::detail::cub::DeviceRadixSortOnesweepKernel<int>", "other"),
])
def test_categorize_op(name, category):
    assert profiling.categorize_op(name) == category


def test_print_op_summary_totals(capsys):
    rows = [("sm90_xmma_fprop_implicit_gemm_bf16", 0.010),
            ("filtered_lrelu_fwd_tc_kernel(a)", 0.005),
            ("sm90_xmma_fprop_implicit_gemm_bf16", 0.010)]
    cats = profiling.print_op_summary(rows, top=5)
    out = capsys.readouterr().out
    assert "device time total = 25.0 ms" in out
    assert "conv (cuDNN/CUTLASS)" in out and "80.0%" in out
    assert "K1 filtered_lrelu fwd" in out and "20.0%" in out
    assert cats == {"conv (cuDNN/CUTLASS)": (pytest.approx(0.020), 2),
                    "K1 filtered_lrelu fwd": (pytest.approx(0.005), 1)}


def _write_trace(path, events):
    with open(path, "w") as fp:
        json.dump({"schemaVersion": 1, "traceEvents": events}, fp)


def test_trace_op_times_reads_the_newest_chrome_trace(tmp_path):
    old = tmp_path / "old.json"
    _write_trace(old, [{"ph": "X", "cat": "kernel", "name": "stale", "ts": 0, "dur": 1.0}])
    os.utime(old, (1, 1))
    (tmp_path / "sub").mkdir()
    _write_trace(tmp_path / "sub" / "new.json", [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 900.0},
        {"ph": "X", "cat": "kernel", "name": "filtered_lrelu_fwd_tc_kernel(x)", "ts": 5,
         "dur": 250.0},
        {"ph": "X", "cat": "kernel", "name": "filtered_lrelu_fwd_tc_kernel(x)", "ts": 300,
         "dur": 250.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 600,
         "dur": 10.0},
        {"ph": "f", "cat": "ac2g", "name": "launch", "ts": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 4, "dur": 3.0},
    ])
    rows = profiling.trace_op_times(str(tmp_path))
    assert rows == [("filtered_lrelu_fwd_tc_kernel(x)", 250e-6),
                    ("filtered_lrelu_fwd_tc_kernel(x)", 250e-6),
                    ("Memcpy DtoH (Device -> Pinned)", 10e-6)]


def test_trace_op_times_refuses_a_cpu_only_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir, profiling.annotate("matmul"):
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    assert log_dir == str(tmp_path) and len(list(tmp_path.glob("*.json"))) == 1
    with pytest.raises(RuntimeError, match="no device kernel"):
        profiling.trace_op_times(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.trace_op_times(str(tmp_path / "empty"))


def test_memory_stats_on_the_cpu():
    assert profiling.device_memory_stats() == {}
    assert profiling.peak_device_memory_gb() == 0.0
    assert profiling.host_memory_gb() > 0.0
    assert profiling.gpu_name_and_power_limit("cpu") is None


def _jax_param_sizes(G, *init_args) -> dict[str, int]:
    shapes = jax.eval_shape(lambda: G.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, *init_args))
    return {flax_path_to_torch_key(tuple(k.key for k in keypath)): int(np.prod(leaf.shape))
            for keypath, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}


@pytest.mark.parametrize("kind", ["lres", "sres"])
def test_module_summary_counts_equal_the_jax_variables(kind):
    if kind == "lres":
        sizes = _jax_param_sizes(jax_lres.VideoGenerator(**LRES_KW), 1, 8)
        G = generator_lres.VideoGenerator(**LRES_KW)
        args, kwargs = (1, 8), dict(generator=torch.Generator().manual_seed(0))
        out_shape = (1, 3, 8, 18, 32)
    else:
        cfg = jax_sres.VideoGenerator(**SRES_KW)
        sizes = _jax_param_sizes(cfg, jnp.zeros((1, 3, 1 + 4, 9, 16)))
        G = generator_sres.VideoGenerator(**SRES_KW)
        args, kwargs = (torch.zeros((1, 3, 1 + 4, 9, 16)),), dict(z=torch.zeros((1, 32)))
        out_shape = (1, 3, 1, 36, 64)
    rows = profiling.module_rows(G, *args, **kwargs)
    assert rows[0]["name"] == "" and rows[0]["output"] == out_shape
    assert max(r["name"].count(".") for r in rows) == 1      # depth 2
    for row in rows:
        prefix = row["name"] + "." if row["name"] else ""
        want = sum(n for key, n in sizes.items() if key.startswith(prefix))
        assert row["params"] == want, row["name"]
    assert any(r["output"] is not None for r in rows[1:])
    table = profiling.module_summary(G, *args, **kwargs)
    assert f"{sum(sizes.values()):,}" in table.splitlines()[1]
