"""The int8 codec kernel (csrc/quant_codec.cu, ops/quant_codec.py)
against its plain version.

On the CPU, ``kernel_model`` does the kernel's work in its order: one
warp per (row, 256-value group) of each last-axis row, lane l holding
values 8l..8l+7 with the tail masked to 0, the absmax found by five
xor-shuffles, and in bf16 a rounding to bf16 after each of the division
by 127, v / scale and q * scale.  It must equal the plain version (which
tests/test_torch_quantize.py holds to the reference) bit for bit; the
same pass over 256-value groups of the flattened tensor must not.

The ``cuda`` legs hold the kernel itself to the plain version, bit for
bit, in f32 and bf16, on contiguous and strided inputs.  They need no
jax and run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_quant_codec.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from brpc_tpu_torch.ops import quant_codec
from brpc_tpu_torch.ops.quant_codec import (fake_quant_int8,
                                            fake_quant_int8_plain)
from brpc_tpu_torch.parallel import quantize

FLT_MIN = np.float32(np.finfo(np.float32).tiny)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cases():
    """The cases of tests/test_torch_quantize.py: a ragged row (2 blocks
    + 188), zero and denormal blocks, ties at scale 1, a short row."""
    rng = np.random.default_rng(0)
    ragged = rng.standard_normal((3, 700)).astype(np.float32)
    special = np.zeros((5, 256), np.float32)
    special[1] = 1e-40                      # all denormal
    special[2] = 1e-37                      # normal, but scale is denormal
    special[2, 3] = 2e-37
    special[3] = rng.standard_normal(256).astype(np.float32)
    special[3, :40] = 3e-41                 # denormals inside a live block
    ties = np.zeros((1, 256), np.float32)   # scale exactly 1.0: x/scale = x
    ties[0, 0] = 127.0
    ties[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return {"ragged": ragged, "zero_and_denormal": special, "ties": ties,
            "short": rng.standard_normal((2, 17)).astype(np.float32)}


def bf16(a) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), kept as f32."""
    a = np.asarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    r = (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32)
    return np.where(np.isnan(a), a, r.view(np.float32))


def _flush(a):
    return np.where(np.abs(a) < FLT_MIN, np.float32(0), a)


def kernel_model(x, dtype="f32", flat=False) -> np.ndarray:
    """The kernel's pass over x (f32 values; bf16 values for "bf16")."""
    x = np.asarray(x, np.float32)
    rnd = bf16 if dtype == "bf16" else (lambda a: a)
    rows = x.reshape(1, -1) if flat else x.reshape(-1, x.shape[-1])
    R, n = rows.shape
    groups = -(-n // 256)
    padded = np.zeros((R, groups * 256), np.float32)   # masked lanes: 0
    padded[:, :n] = rows
    v = _flush(padded.reshape(R, groups, 32, 8))     # [row, group, lane, 8]
    m = np.abs(v).max(axis=-1)                        # each lane's 8
    for off in (16, 8, 4, 2, 1):                      # __shfl_xor_sync
        m = np.maximum(m, m[..., np.arange(32) ^ off])
    scale = _flush(rnd(m / np.float32(127)))[..., None]   # every lane's
    live = scale > 0
    with np.errstate(invalid="ignore", divide="ignore"):
        t = rnd(v / np.where(live, scale, np.float32(1)))
    q = np.where(live, np.clip(np.rint(t), -127, 127), np.float32(0))
    out = rnd((q * scale).astype(np.float32))
    return out.reshape(R, -1)[:, :n].reshape(x.shape)


def _plain(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x)).to(DTYPES[dtype])
    return fake_quant_int8_plain(t).float().numpy()


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    bad = got.view(np.uint32) != want.view(np.uint32)
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


def test_bf16_rounding_matches_torch():
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    x[:4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -(1.0 + 2 ** -8), 1e-40]
    _bits_equal(bf16(x), torch.from_numpy(x).bfloat16().float().numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(_cases()))
def test_model_equals_plain_on_the_cases(name, dtype):
    x = _cases()[name]
    if dtype == "bf16":
        x = bf16(x)
    _bits_equal(kernel_model(x, dtype), _plain(x, dtype))


@settings(max_examples=60, deadline=None)
@given(data=st.data(), dtype=st.sampled_from(sorted(DTYPES)))
def test_model_equals_plain_on_drawn_rows(data, dtype):
    rows = data.draw(st.integers(1, 4))
    n = data.draw(st.integers(1, 700))
    scale = data.draw(st.sampled_from([1e-39, 1e-3, 1.0, 1e6, 1e36]))
    x = data.draw(hnp.arrays(np.float32, (rows, n), elements=st.floats(
        -1, 1, width=32))) * np.float32(scale)
    if dtype == "bf16":
        x = bf16(x)
    _bits_equal(kernel_model(x, dtype), _plain(x, dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flattened_blocking_fails_on_ragged_rows(dtype):
    """The trap: 256-value groups of the flattened tensor differ from
    per-row groups whenever n % 256 != 0."""
    x = _cases()["ragged"]
    if dtype == "bf16":
        x = bf16(x)
    flat = kernel_model(x, dtype, flat=True)
    assert (flat.view(np.uint32) != _plain(x, dtype).view(np.uint32)).any()


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    x = torch.from_numpy(_cases()["ragged"])
    before = fake_quant_int8.launches
    got = fake_quant_int8(x)
    assert fake_quant_int8.launches == before
    assert torch.equal(got, fake_quant_int8_plain(x))
    assert torch.equal(quantize.fake_quant_int8(x), got)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float16"):
        fake_quant_int8(torch.zeros(4, 256, dtype=torch.float16))
    with pytest.raises(ValueError, match="at least 1 dim"):
        fake_quant_int8(torch.tensor(1.0))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fake_quant_int8(torch.zeros(4, 256, device="meta"))


# --- on the card ------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc for the kernel")


def _card_cases():
    rng = np.random.default_rng(5)
    out = dict(_cases())
    for shape in ((4, 4096), (5, 260), (3, 1001), (1, 1_000_003),
                  (2, 3, 516)):
        out[f"normal{shape}"] = rng.standard_normal(shape).astype(np.float32)
    out["wide"] = (rng.standard_normal((6, 777)) * np.float32(1e30)).astype(
        np.float32)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(_card_cases()))
def test_kernel_is_bit_equal_to_plain_on_the_card(name, dtype):
    _card()
    x = torch.from_numpy(_card_cases()[name]).to(DTYPES[dtype])
    xd = x.cuda()
    before = fake_quant_int8.launches
    got = fake_quant_int8(xd)
    torch.cuda.synchronize()
    assert fake_quant_int8.launches == before + 1
    _bits_equal(got.float().cpu(), fake_quant_int8_plain(xd).float().cpu())
    _bits_equal(got.float().cpu(), fake_quant_int8_plain(x).float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_reads_strided_inputs(dtype):
    _card()
    g = torch.Generator(device="cuda").manual_seed(6)
    base = torch.randn(64, 1030, generator=g, device="cuda").to(DTYPES[dtype])
    for view in (base[:, ::2], base.t(), base[1:, 3:]):
        got = fake_quant_int8(view)
        _bits_equal(got.float().cpu(),
                    fake_quant_int8(view.contiguous()).float().cpu())
        _bits_equal(got.float().cpu(),
                    fake_quant_int8_plain(view).float().cpu())


@pytest.mark.cuda
def test_kernel_refuses_float16_and_other_blocks_on_the_card():
    _card()
    with pytest.raises(ValueError, match="float16"):
        fake_quant_int8(torch.zeros(4, 256, dtype=torch.float16,
                                    device="cuda"))
    with pytest.raises(ValueError, match="blocks of 256"):
        fake_quant_int8(torch.zeros(4, 256, device="cuda"), block=128)


@pytest.mark.cuda
def test_codec_pass_of_a_cuda_tensor_takes_the_kernel():
    _card()
    x = torch.randn(8, 4096, device="cuda")
    before = quant_codec.fake_quant_int8.launches
    got = quantize.fake_quant(x, "int8")
    assert quant_codec.fake_quant_int8.launches == before + 1
    assert float((got - x).abs().max()) <= quantize.int8_error_bound(x)
