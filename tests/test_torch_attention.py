"""The port's plain attention ops against the reference package: the model
function ``decode_attention`` (S >= 1, per-sequence q_start, window with
global_flag), the kernel oracle ``ref.py`` against the Pallas kernel run in
interpret mode, and the cache inserts.  The hand kernel itself runs only on
the card: ``tests/test_torch_kernels_cuda.py``."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.models import attention as jax_attn
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode_attention_ref, ops
from repro_torch.models import attention

# as tests/test_kernels.py
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, dtype)
    t = torch.from_numpy(np.array(j, np.float32)).to(TORCH_DTYPE[dtype])
    return j, t


def _close(got_torch, want_jax, dtype):
    np.testing.assert_allclose(
        got_torch.float().numpy(), np.asarray(want_jax, np.float32),
        atol=TOLS[dtype], rtol=TOLS[dtype],
    )


# (S, window, global_flag)
MODEL_CASES = [
    (1, None, None),
    (8, None, None),
    (1, 6, 0.0),
    (8, 6, 0.0),
    (8, 6, 1.0),
]


@pytest.mark.parametrize("case", MODEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(case, dtype):
    S, window, flag = case
    B, T, Hq, Hkv, dh = 3, 40, 8, 2, 16
    rng = np.random.default_rng(S * 10 + (window or 0))
    qj, qt = _pair(rng.normal(size=(B, S, Hq, dh)), dtype)
    kj, kt = _pair(rng.normal(size=(B, T, Hkv, dh)), dtype)
    vj, vt = _pair(rng.normal(size=(B, T, Hkv, dh)), dtype)
    q_start = np.array([0, 9, 31], np.int32)  # differs per sequence
    want = jax_attn.decode_attention(
        qj, kj, vj, jnp.asarray(q_start), window=window,
        global_flag=None if flag is None else jnp.asarray(flag),
    )
    got = attention.decode_attention(
        qt, kt, vt, torch.from_numpy(q_start), window=window, global_flag=flag
    )
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, S, Hq, dh)
    _close(got, want, dtype)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 4, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 16, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 16, 2, 8)).astype(np.float32))
    qs = torch.tensor([0, 7], dtype=torch.int32)
    before = dict(ops.decode_attention.launches_by_variant)
    got = ops.decode_attention(q, k, v, qs, window=3)
    want = attention.decode_attention(q, k, v, qs, window=3)
    assert torch.equal(got, want)
    assert ops.decode_attention.launches_by_variant == before  # no kernel launched


def test_wrapper_rejects_other_devices():
    q = torch.empty(1, 1, 4, 8, device="meta")
    kv = torch.empty(1, 16, 2, 8, device="meta")
    qs = torch.zeros(1, dtype=torch.int32, device="meta")
    # meta is the dry-run's shape-only path: an output of q's shape, no launch
    assert ops.decode_attention(q, kv, kv, qs).shape == q.shape
    # any device but cpu, cuda and meta is refused before any work
    other = types.SimpleNamespace(device=torch.device("xpu", 0))
    with pytest.raises(ValueError, match="device"):
        ops.decode_attention(other, kv, kv, qs)


@pytest.mark.parametrize("shape", [
    # (B, S, Hq, Hkv, T, dh)
    (1, 1, 32, 4, 1024, 64),
    (1, 64, 32, 4, 1024, 64),
    (4, 1, 32, 4, 1024, 64),
    (2, 64, 8, 4, 1024, 256),
    (1, 16, 8, 2, 128, 8),
    (3, 1, 4, 1, 200, 128),
])
def test_split_plan_covers_the_cache(shape):
    B, S, Hq, Hkv, T, dh = shape
    tk, split_len, n_splits = ops.plan(B, S, Hq, Hkv, T, dh, n_sm=132)
    assert split_len % tk == 0
    assert (n_splits - 1) * split_len < T <= n_splits * split_len


DECODE_CASES = [
    # (B, T, Hq, Hkv, d, blk) as tests/test_kernels.py
    (2, 256, 4, 2, 64, 128),
    (1, 384, 4, 1, 128, 128),
    (3, 200, 2, 2, 64, 128),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_kernel(case, dtype):
    B, T, Hq, Hkv, d, blk = case
    rng = np.random.default_rng(B * T + d)
    qj, qt = _pair(rng.normal(size=(B, Hq, d)), dtype)
    kj, kt = _pair(rng.normal(size=(B, T, Hkv, d)), dtype)
    vj, vt = _pair(rng.normal(size=(B, T, Hkv, d)), dtype)
    lens = rng.integers(1, T + 1, size=(B,)).astype(np.int32)
    want = pallas_decode(qj, kj, vj, jnp.asarray(lens), block_k=blk, interpret=True)
    got = decode_attention_ref(
        qt.reshape(B, Hkv, Hq // Hkv, d), kt, vt, torch.from_numpy(lens)
    ).reshape(B, Hq, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inserts_match_reference(dtype):
    B, T, H, d, c = 3, 24, 2, 8, 5
    rng = np.random.default_rng(11)
    cache_len = np.array([0, 4, 19], np.int32)
    # a written prefix and a zeroed tail, as the engine guarantees
    base = rng.normal(size=(B, T, H, d))
    base[np.arange(T)[None, :] >= cache_len[:, None]] = 0.0
    new = rng.normal(size=(B, c, H, d))
    cj, ct = _pair(base, dtype)
    nj, nt = _pair(new, dtype)
    want = jax_attn.insert_chunk(cj, nj, jnp.asarray(cache_len))
    got = attention.insert_chunk(ct.clone(), nt, torch.from_numpy(cache_len))
    assert torch.equal(got, torch.from_numpy(np.array(want, np.float32)).to(got.dtype))

    one_j, one_t = _pair(new[:, :1], dtype)
    want = jax_attn.insert_kv(cj, one_j, jnp.asarray(cache_len))
    out = ct.clone()
    got = attention.insert_kv(out, one_t, torch.from_numpy(cache_len))
    assert got is out  # in place
    assert torch.equal(got, torch.from_numpy(np.array(want, np.float32)).to(got.dtype))


def test_failed_build_raises(tmp_path, monkeypatch):
    if build.shutil.which("nvcc"):
        pytest.skip("nvcc is present: a build would not fail")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build.load("decode_attention")


def test_every_kernel_source_is_found():
    assert [p.name for p in build.sources()] == [
        "decode_attention.cu", "embedding_bag.cu", "flash_attention.cu", "gnn_aggregate.cu"]


def test_ptxas_report_reads_each_kernel(tmp_path, monkeypatch):
    """The report ptxas leaves beside a library: each kernel's mangled
    name, registers, spill bytes and the codes of its notes that it
    serialized the kernel's wgmmas; none before a build."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert build.ptxas_report("flash_attention") == []
    report = build._target(build.KERNELS_DIR / "flash_attention" / "csrc" /
                           "flash_attention.cu").with_suffix(".ptxas.txt")
    dkdv = ("_ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_2c13897927flash_bwd_dkdv_wgmma_"
            "kernelILi4EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiiiif")
    fwd = ("_ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_2c13897916flash_fwd_kernelIfLi4ELi8EE"
           "EvPKT_S3_S3_PS1_Pfiiiiiiif")
    report.write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{dkdv}' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN49_GLOBAL__N__2c138979\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN49_GLOBAL__N__2c138979\n"
        "    24 bytes stack frame, 28 bytes spill stores, 76 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 384 bytes cmem[0]\n"
        "ptxas info    : (C7519) warpgroup.arrive is injected in around line 90194 by compiler "
        f"to allow use of registers in GMMA in function '{dkdv}'\n"
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
        f"serialized due to insufficient register resources for the function '{dkdv}'\n"
    )
    assert build.ptxas_report("flash_attention") == [
        {"kernel": dkdv, "registers": 168, "spill_stores": 0, "spill_loads": 0,
         "serialized": "C7512"},
        {"kernel": fwd, "registers": 255, "spill_stores": 28, "spill_loads": 76,
         "serialized": ""},
    ]
