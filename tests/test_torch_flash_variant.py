"""Which flash-attention kernels take a shape: ``variant()`` of the port's
wrapper, on the CPU.  The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py`` checks there that every case runs the
variant chosen here, and that the train and gemma3 shapes run the wgmma
kernels)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (
    attention_ref, flash_attention, reset_launches, variant,
)


@pytest.mark.parametrize("dh", range(8, 129, 8))
def test_bf16_head_dims_up_to_128_take_wgmma(dh):
    assert variant(torch.bfloat16, dh, 8) == "wgmma"


@pytest.mark.parametrize("dh", range(136, 257, 8))
def test_bf16_head_dims_above_128_take_wgmma(dh):
    assert variant(torch.bfloat16, dh, 8) == "wgmma"


@pytest.mark.parametrize("dh", [8, 64, 128, 136, 256])
def test_fp32_takes_fma(dh):
    """fp32 takes the three-pass TF32 kernels (named for the FMA kernels
    they replaced) at every head dim."""
    assert variant(torch.float32, dh, 8) == "tf32x3"


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32, 64])
def test_groups_dividing_64_take_wgmma(G):
    assert variant(torch.bfloat16, 64, G) == "wgmma"


@pytest.mark.parametrize("G", [3, 5, 6, 12, 72, 96, 128])
def test_groups_not_dividing_64_take_wgmma_rows(G):
    """A 64-row box of q holds whole positions only where G divides 64; for
    any other group the bf16 kernels read a gathered copy of the rows
    (wgmma_rows), at every head dim.  The fp32 kernels tile the split's
    rows, so every group takes them."""
    assert {variant(torch.bfloat16, dh, G) for dh in range(8, 257, 8)} == {"wgmma_rows"}
    assert variant(torch.float32, 64, G) == "tf32x3"


@pytest.mark.parametrize("G", [1, 2, 3, 8, 64, 72, 128])
def test_fp32_takes_tf32x3_at_every_head_dim_and_group(G):
    assert {variant(torch.float32, dh, G) for dh in range(8, 257, 8)} == {"tf32x3"}


@pytest.mark.parametrize("dh", [136, 192, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 8, 12])
def test_head_dims_above_128_take_wgmma_where_the_group_divides_64(dh, G):
    assert variant(torch.bfloat16, dh, G) == ("wgmma" if 64 % G == 0 else "wgmma_rows")


@pytest.mark.parametrize("dh", [0, 12, 100, 264])
def test_head_dims_no_kernel_takes_raise(dh):
    with pytest.raises(ValueError, match="head dim"):
        variant(torch.bfloat16, dh, 8)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="fp32 or bf16"):
        variant(dtype, 64, 8)


def test_cpu_tensors_count_no_launch():
    """A CPU tensor runs the plain version: no variant's counter moves."""
    reset_launches()
    q = torch.randn(1, 16, 8, 64, dtype=torch.bfloat16)
    kv = torch.randn(1, 16, 1, 64, dtype=torch.bfloat16)
    out = flash_attention(q, kv, kv)
    torch.testing.assert_close(out, attention_ref(q, kv, kv), atol=0, rtol=0)
    assert flash_attention.launches_fwd == flash_attention.launches_bwd == 0
    assert flash_attention.launches_by_variant == {
        v: {"fwd": 0, "bwd": 0} for v in ("tf32x3", "wgmma", "wgmma_rows")
    }
