"""PyTorch port, ``mx.rtc`` on a machine with no card.

``mxnet_tpu_torch.rtc`` ports the JAX package's user-kernel escape hatch
(``mxnet_tpu/rtc.py``, ``PallasModule`` over ``pl.pallas_call``) as the
reference's ``CudaModule``: CUDA source compiled by NVRTC at the first
launch. Here, without CUDA: the port's ``PallasModule`` raises (the
inverse of ``tests/test_misc_modules.py::test_rtc_cuda_module_raises``),
a module constructs without compiling, signatures parse or raise, a
launch on the CPU raises before anything is compiled, a missing NVRTC or
driver library raises ``MXNetError``, and the plain versions of the user
kernels in ``chip_smoke.py`` equal numpy. The kernels themselves run in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _cuda_driver as drv
from mxnet_tpu_torch.base import MXNetError
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def cs():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_rtc", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_compile(monkeypatch):
    """Fail the test if anything reaches NVRTC or the driver."""
    def refuse(*a, **k):
        raise AssertionError("compiled or launched")
    for name in ("compile_program", "load_module", "launch"):
        monkeypatch.setattr(drv, name, refuse)


def test_pallas_module_raises():
    with pytest.raises(MXNetError, match="CudaModule"):
        mx.rtc.PallasModule(lambda x_ref, o_ref: None)


def test_cuda_module_constructs_without_compiling(no_compile):
    mod = mx.rtc.CudaModule("__global__ void k(float* x) {}",
                            options=["--use_fast_math"], exports=["k"])
    k = mod.get_kernel("k", "float* x")
    assert mod.options == ("--use_fast_math",) and mod.exports == ("k",)
    assert isinstance(k, mx.rtc.Kernel) and k.name == "k"
    assert mod._loaded == {} and k.launches == 0


def test_get_kernel_parses_signatures(no_compile):
    mod = mx.rtc.CudaModule("")
    k = mod.get_kernel("k", "const float* x, float *y, int n, double s, "
                            "int32_t* a, const int64_t *b, uint8_t* c, "
                            "int8_t d, const __half* h, __half v")
    got = [(a.const, a.ctype, a.pointer, a.name) for a in k.signature]
    assert got == [(True, "float", True, "x"), (False, "float", True, "y"),
                   (False, "int", False, "n"), (False, "double", False, "s"),
                   (False, "int32_t", True, "a"),
                   (True, "int64_t", True, "b"),
                   (False, "uint8_t", True, "c"),
                   (False, "int8_t", False, "d"),
                   (True, "__half", True, "h"),
                   (False, "__half", False, "v")]
    assert mod.get_kernel("k", "").signature == []


@pytest.mark.parametrize("signature", ["float4* x", "const float* x, long n",
                                       "float** x", "const float* x,"])
def test_get_kernel_refuses_bad_signatures(no_compile, signature):
    with pytest.raises(MXNetError):
        mx.rtc.CudaModule("").get_kernel("k", signature)


def test_get_kernel_refuses_names_missing_from_exports(no_compile):
    mod = mx.rtc.CudaModule("", exports=("fwd<float>",))
    mod.get_kernel("fwd<float>", "float* x")
    with pytest.raises(MXNetError, match="exports"):
        mod.get_kernel("fwd<double>", "double* x")


@pytest.mark.parametrize("ctx", [mx.cpu(), mx.gpu(0)])
def test_launch_on_the_cpu_raises(no_compile, ctx):
    """A CPU context raises; a GPU context without CUDA raises; with CPU
    arrays either way, and nothing is compiled."""
    k = mx.rtc.CudaModule("").get_kernel("axpy", "const float* x, float* y,"
                                                 " float a, int n")
    with mx.cpu():
        x = mx.nd.array(np.arange(4, dtype="float32"))
    with pytest.raises(MXNetError):
        k.launch([x, x, 2.0, 4], ctx, (1,), (32,))
    assert k.launches == 0


def test_missing_nvrtc_raises(monkeypatch):
    monkeypatch.setattr(drv, "_nvrtc_candidates", lambda: [])
    monkeypatch.setattr(drv, "_libs", {})
    with pytest.raises(MXNetError, match="libnvrtc not found"):
        drv.compile_program("", [], [], "cubin")


def test_missing_driver_raises(monkeypatch):
    def no_lib(path, *a, **k):
        raise OSError(f"{path}: cannot open shared object file")
    monkeypatch.setattr(drv.ctypes, "CDLL", no_lib)
    monkeypatch.setattr(drv, "_libs", {})
    with pytest.raises(MXNetError, match="libcuda.so.1"):
        drv.make_current(0)


def test_launch_packs_exact_c_types(monkeypatch):
    """The scalars reach ``cuLaunchKernel`` in the signature's C types."""
    k = mx.rtc.CudaModule("").get_kernel(
        "k", "int n, int64_t m, double s, __half h, uint8_t b")
    values = k._pack([3, 2 ** 40, 0.1, 1.5, 255], torch.device("cuda", 0))
    assert [type(v) for v in values] == [ctypes.c_int32, ctypes.c_int64,
                                        ctypes.c_double, ctypes.c_uint16,
                                        ctypes.c_uint8]
    assert [v.value for v in values] == [
        3, 2 ** 40, 0.1, int(np.float16(1.5).view(np.uint16)), 255]


def test_plain_versions_equal_numpy(cs):
    rng = np.random.RandomState(0)
    x = rng.randn(1000).astype("float32")
    y = rng.randn(1000).astype("float32")
    got = cs.axpy_plain(torch.from_numpy(x), torch.from_numpy(y), 2.0)
    np.testing.assert_array_equal(got.numpy(), np.float32(2) * x + y)

    n, c = 9, 37
    logits = (2.0 * rng.randn(n, c)).astype("float32")
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    got_p = cs.softmax_plain(torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got_p, p, rtol=0, atol=1e-6)

    labels = rng.randint(0, c, n).astype("float32")
    labels[0], labels[1], labels[2] = -1.0, 3.7, float(c)  # wraps, truncates, NaN
    g = p.copy()
    for i in range(n):
        if i != 2:
            g[i, int(labels[i])] -= 1.0
    g /= n
    g[2] = np.nan
    got_g = cs.softmax_ce_bwd_plain(torch.from_numpy(p),
                                    torch.from_numpy(labels), 1.0 / n)
    np.testing.assert_allclose(got_g.numpy(), g, rtol=0, atol=1e-6)
