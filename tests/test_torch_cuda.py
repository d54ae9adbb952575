"""Torch port on the card: each CUDA kernel against its plain torch version,
the port's fits through the kernels against the plain backend, and the
serving paths through the flash-attention and ssd_scan kernels.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the CUDA kernels have no CPU mode).  The file imports no jax, so
it also runs where only the port's dependencies are installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch.core as tc
from repro_torch.core.graph import ring
from repro_torch.kernels import csvm_update as cu
from repro_torch.kernels import ops, ref

from _torch_cases import ROUND_CASES, problem

pytestmark = pytest.mark.cuda

# fp32: the same fp32 arithmetic summed in another order on the card
ATOL = 1e-5
# bf16 kernel against its plain version: both round B, w and beta_bar to
# bf16 at the same points, so they differ only where an fp32 summation-order
# difference moves an operand across a bf16 rounding boundary.  One such
# flip moves B+ by about |b| 2^-8 omega c_h lmax(X'X/n) ~ |b| / 2400 at
# |b| ~ 0.05: 2e-5 (measured 2.2e-5 at X (16, 1024, 4096), 5 rounds + KKT,
# in chip_smoke.py); the limit holds a few flips.
ATOL_BF16_KERNEL = 1e-4
# a bf16 fit against the fp32 plain fit: the repo's bf16 tier
ATOL_BF16 = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(d, dev):
    return {k: torch.tensor(v, device=dev) for k, v in d.items()}


def _close(got, want, tol):
    if want.dim() == 0 and torch.isinf(want):
        assert torch.isinf(got) and float(got) > 0
    else:
        torch.testing.assert_close(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5, 37, 130), (16, 64, 4096)])
def test_block_update_matches_plain(cuda, dtype, shape):
    t = _on(problem(*shape, seed=3), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["neigh"], t["rho"],
            t["omega"], t["lam"])
    before = ops.launches["csvm_block_update"]
    got = ops.csvm_block_update(*args, h=0.3)
    assert ops.launches["csvm_block_update"] == before + 1
    want = cu.csvm_block_update_plain(*args, h=0.3)
    _close(got, want, ATOL if dtype == torch.float32 else ATOL_BF16_KERNEL)


@pytest.mark.parametrize("kernel", ["epanechnikov", "laplacian", "gaussian",
                                    "uniform", "logistic"])
def test_local_update_matches_plain(cuda, kernel):
    t = _on(problem(4, 29, 70, seed=4), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"],
            t["omega"], t["lam"])
    before = ops.launches["csvm_local_update"]
    got = ops.csvm_local_update(*args, h=0.3, kernel=kernel)
    one = ops.csvm_local_update(*(a[0] for a in args[:7]), t["lam"], h=0.3,
                                kernel=kernel)
    assert ops.launches["csvm_local_update"] == before + 2
    want = cu.csvm_local_update_plain(*args, h=0.3, kernel=kernel)
    _close(got, want, ATOL)
    _close(one, want[0], ATOL)


@pytest.mark.parametrize("case", ROUND_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_block_matches_plain(cuda, case, dtype):
    m, n, p, R, nact, kkt, lam0, _, kernel = case
    t = _on(problem(m, n, p, seed=m + n + p), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["W"], t["deg"],
            t["rho"], t["omega"], t["lam"])
    kw = dict(tau=1.0, lam0=lam0, h=0.35, kernel=kernel, num_rounds=R,
              want_kkt=kkt)
    before = ops.launches["csvm_round_block"]
    got = ops.csvm_round_block(
        *args, torch.tensor(nact, dtype=torch.int32, device=cuda), **kw)
    assert ops.launches["csvm_round_block"] == before + 1
    want = cu.csvm_round_block_plain(*args, nact, **kw)
    for g, w in zip(got, want):
        _close(g, w, ATOL if dtype == torch.float32 else ATOL_BF16_KERNEL)
    if nact == 0:
        assert torch.equal(got[0], t["B"]) and torch.equal(got[1], t["P"])


def test_round_block_is_deterministic(cuda):
    t = _on(problem(6, 50, 300, seed=9), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["W"], t["deg"], t["rho"],
            t["omega"], t["lam"], torch.tensor(7, dtype=torch.int32,
                                               device=cuda))
    kw = dict(tau=1.0, lam0=0.0, h=0.3, num_rounds=7, want_kkt=True)
    a, b = ops.csvm_round_block(*args, **kw), ops.csvm_round_block(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("instance,grid", [("stream", None), ("stream", 1),
                                           ("stream", 7), ("direct", None)])
@pytest.mark.parametrize("case", ROUND_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_block_instances_match_plain(cuda, case, dtype, instance,
                                           grid):
    """Each instance of the round kernel against the plain version: the
    stream instance at its own grid (node-crossing ranges in the last two
    cases), at one block and at 7 blocks (ranges crossing nodes in every
    case with m*n > 7); held rounds and nact = 0 leave B and P bit-equal."""
    m, n, p, R, nact, kkt, lam0, _, kernel = case
    t = _on(problem(m, n, p, seed=m + n + p), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["W"], t["deg"],
            t["rho"], t["omega"], t["lam"])
    kw = dict(tau=1.0, lam0=lam0, h=0.35, kernel=kernel, num_rounds=R,
              want_kkt=kkt)
    before = dict(ops.round_block_launches)
    got = ops._round_block_launch(
        *args, torch.tensor(nact, dtype=torch.int32, device=cuda), instance,
        grid=grid, **kw)
    ran = {k: v - before[k] for k, v in ops.round_block_launches.items()}
    assert ran == {k: int(k == instance) for k in ops.ROUND_INSTANCES}
    want = cu.csvm_round_block_plain(*args, nact, **kw)
    for g, w in zip(got, want):
        _close(g, w, ATOL if dtype == torch.float32 else ATOL_BF16_KERNEL)
    if nact == 0:
        assert torch.equal(got[0], t["B"]) and torch.equal(got[1], t["P"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_instance_is_deterministic(cuda, dtype):
    """Two launches of the stream instance give the same bits: B, P and
    the statistic (ragged p, ranges crossing nodes, the KKT pass)."""
    t = _on(problem(6, 50, 301, seed=9), cuda)
    args = (t["X"].to(dtype), t["y"], t["B"], t["P"], t["W"], t["deg"],
            t["rho"], t["omega"], t["lam"],
            torch.tensor(7, dtype=torch.int32, device=cuda))
    kw = dict(tau=1.0, lam0=0.05, h=0.3, num_rounds=7, want_kkt=True)
    assert ops.round_block_instance(6, 50, 301, dtype) == "stream"
    a = ops.csvm_round_block(*args, **kw)
    b = ops._round_block_launch(*args, "stream", grid=5, **kw)
    c = ops._round_block_launch(*args, "stream", grid=5, **kw)
    for x, y in zip(b, c):
        assert torch.equal(x, y)
    for x, y in zip(a, ops.csvm_round_block(*args, **kw)):
        assert torch.equal(x, y)


def test_p_above_the_stream_limit_takes_the_direct_instance(cuda):
    """p = 8200 > 8192: the wrapper launches the direct instance, which
    matches the plain version; the stream instance refuses it."""
    m, n, p = 2, 5, ops.STREAM_MAX_P + 8
    t = _on(problem(m, n, p, seed=2), cuda)
    args = (t["X"], t["y"], t["B"], t["P"], t["W"], t["deg"], t["rho"],
            t["omega"], t["lam"])
    kw = dict(tau=1.0, lam0=0.0, h=0.3, num_rounds=3, want_kkt=True)
    nact = torch.tensor(3, dtype=torch.int32, device=cuda)
    assert ops.round_block_instance(m, n, p) == "direct"
    assert ops.megakernel_supported(m, n, p, torch.float32, device=cuda)
    ops.reset_launches()
    got = ops.csvm_round_block(*args, nact, **kw)
    assert ops.round_block_launches == {"stream": 0, "direct": 1}
    for g, w in zip(got, cu.csvm_round_block_plain(*args, 3, **kw)):
        _close(g, w, ATOL)
    with pytest.raises(ValueError, match="p <= 8192"):
        ops._round_block_launch(*args, nact, "stream", **kw)
    assert ops.round_block_launches == {"stream": 0, "direct": 1}


def test_stream_instance_raises_on_a_misaligned_x(cuda):
    """X's base off a 16-byte boundary raises before any launch (the bulk
    copies need it), and is not rerouted to the direct instance."""
    t = _on(problem(3, 20, 9, seed=1), cuda)
    flat = torch.zeros(1 + t["X"].numel(), device=cuda)
    X = flat[1:].view(t["X"].shape)
    X.copy_(t["X"])
    before = dict(ops.launches), dict(ops.round_block_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.csvm_round_block(X, t["y"], t["B"], t["P"], t["W"], t["deg"],
                             t["rho"], t["omega"], t["lam"],
                             torch.tensor(2, dtype=torch.int32, device=cuda),
                             tau=1.0, lam0=0.0, h=0.3, num_rounds=2)
    assert (dict(ops.launches), dict(ops.round_block_launches)) == before


@pytest.mark.parametrize("backend", ["megakernel", "megakernel_bf16"])
def test_megakernel_fits_take_the_stream_instance(cuda, backend):
    """Every csvm_round_block launch of the two megakernel fits (one for
    decsvm_fit, one per check block for the KKT fit) is on the stream
    instance."""
    sim = tc.SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = tc.generate(sim, seed=1)
    W = ring(sim.m)
    cfg = tc.ADMMConfig(lam=0.05, max_iter=60, backend=backend)
    ops.reset_launches()
    tc.decsvm_fit(X, y, W, cfg)
    assert ops.round_block_launches == {"stream": 1, "direct": 0}
    ops.reset_launches()
    _, t = tc.decsvm_fit_tol(X, y, W, cfg, tol=-1.0, stop_rule="kkt",
                             check_every=7)
    assert ops.launches["csvm_round_block"] == -(-60 // 7)
    assert ops.round_block_launches == {
        "stream": ops.launches["csvm_round_block"], "direct": 0}


def test_wrappers_raise_on_bad_operands(cuda):
    t = _on(problem(2, 5, 4), cuda)
    args = [t["X"], t["y"], t["B"], t["P"], t["neigh"], t["rho"], t["omega"],
            t["lam"]]
    with pytest.raises(TypeError):
        ops.csvm_block_update(t["X"].double(), *args[1:], h=0.3)
    with pytest.raises(ValueError):
        ops.csvm_block_update(args[0], t["y"].cpu(), *args[2:], h=0.3)
    with pytest.raises(TypeError):
        ops.csvm_local_update(t["X"].bfloat16(), *args[1:], h=0.3)
    assert ops.megakernel_supported(2, 5, 4, torch.float32, device=cuda)
    assert not ops.megakernel_supported(10**4, 10**4, 10**4, torch.float32,
                                        device=cuda)


@pytest.mark.parametrize("backend", ["pallas", "megakernel",
                                     "megakernel_bf16"])
def test_fit_through_the_kernels_matches_the_plain_fit(cuda, backend):
    sim = tc.SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = tc.generate(sim, seed=1)
    W = ring(sim.m)
    cfg = lambda b: tc.ADMMConfig(lam=0.05, max_iter=60, backend=b)
    ops.reset_launches()
    got = tc.decsvm_fit(X, y, W, cfg(backend))
    assert got.is_cuda and sum(ops.launches.values()) >= 1
    want = tc.decsvm_fit(X, y, W, cfg("jnp"))
    tol = ATOL_BF16 if backend == "megakernel_bf16" else ATOL
    _close(got, want, tol)
    Bt, t = tc.decsvm_fit_tol(X, y, W, cfg(backend), tol=-1.0,
                              stop_rule="kkt", check_every=7)
    assert int(t) == 60
    _close(Bt, want, tol)


def test_refused_round_block_loops_the_block_update_kernel(cuda,
                                                           monkeypatch):
    """When the residency rule refuses the round kernel, the megakernel fit
    runs one csvm_block_update launch per round and never the plain
    ``local_update`` on the card."""
    from repro_torch.core import solver
    sim = tc.SimConfig(p=20, s=4, m=4, n=60)
    X, y, _ = tc.generate(sim, seed=1)
    W = ring(sim.m)
    cfg = lambda b: tc.ADMMConfig(lam=0.05, max_iter=60, backend=b)
    want = tc.decsvm_fit(X, y, W, cfg("jnp"))
    monkeypatch.setattr(ops, "megakernel_supported", lambda *a, **k: False)

    def no_reference(*a, **k):
        raise AssertionError("the megakernel backend reached local_update")
    monkeypatch.setattr(solver, "local_update", no_reference)
    ops.reset_launches()
    got = tc.decsvm_fit(X, y, W, cfg("megakernel"))
    assert ops.launches["csvm_block_update"] == 60
    assert ops.launches["csvm_round_block"] == 0
    _close(got, want, ATOL)


# --------------------------------------------------------------------------
# flash_attention and the serving path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.FLASH_CASES)
def test_flash_attention_matches_plain(cuda, case, dtype):
    """The shapes and limits of chip_smoke.py: fp32 within 2e-5, bf16
    within one bf16 ulp of the plain output; qwen3-14b's shapes go in as
    the model's strided views."""
    q, k, v = chip_smoke.attention_inputs(torch, case, dtype, cuda, seed=1)
    causal, window = case[5], case[6]
    before = ops.launches["flash_attention"]
    instance = ops.flash_instance(q.dtype, q.shape[-1])
    before_instance = ops.flash_launches[instance]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launches["flash_attention"] == before + 1
    assert ops.flash_launches[instance] == before_instance + 1
    want = ref.mha(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _, share = chip_smoke.flash_deviation(torch, got, want, dtype)
    assert share <= 1.0


def test_tensor_core_flash_raises_on_a_misaligned_base(cuda):
    """bf16 at D = 128 takes the tensor-core instance; a base off a 16-byte
    boundary raises before any launch, and is not rerouted."""
    flat = torch.zeros(1 + 4 * 64 * 128, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(1, 4, 64, 128)
    k = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16, device=cuda)
    before = dict(ops.launches), dict(ops.flash_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, k, k)
    assert (dict(ops.launches), dict(ops.flash_launches)) == before


def test_reduced_bf16_prefill_takes_the_tensor_core_instance(cuda):
    """A bf16 block prefill of the reduced qwen3-14b (D = 64, group 2):
    one tensor-core launch per layer, logits within chip_smoke's bf16
    in-model limit of the plain attention's."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get_reduced("qwen3_14b", param_dtype="bfloat16")
    params = model.init_params(cfg, seed=0, device=cuda)
    ops.reset_launches()
    dev, _ = chip_smoke.kernel_vs_plain_in_model(
        torch, ops, cfg, params, label="reduced bf16",
        tol=chip_smoke.MODEL_TOL["bfloat16"], prompt=333)
    assert ops.flash_launches == {"wgmma": cfg.num_layers, "fma": 0}
    assert dev <= chip_smoke.MODEL_TOL["bfloat16"]


def test_flash_attention_raises_without_its_library(cuda, monkeypatch,
                                                    tmp_path):
    """A CUDA tensor gets the kernel or an error — never the plain
    version."""
    from repro_torch.kernels import build
    q = torch.randn(1, 4, 64, 32, device=cuda)
    k = torch.randn(1, 2, 64, 32, device=cuda)
    monkeypatch.setitem(build.SOURCES, "flash_attention",
                        tmp_path / "missing.cu")
    monkeypatch.delitem(build._loaded, "flash_attention", raising=False)
    ops._flash_lib.cache_clear()
    before = dict(ops.launches)
    try:
        with pytest.raises((OSError, RuntimeError)):
            ops.flash_attention(q, k, k)
    finally:
        ops._flash_lib.cache_clear()
    assert ops.launches == before


def test_attention_and_prefill_launch_the_kernel(cuda, monkeypatch):
    """attention_forward launches the kernel once, a block prefill once
    per layer, and both agree with the plain attention on the card."""
    from repro_torch import configs
    from repro_torch.models import attention, model
    from repro_torch.models.prefill import prefill
    cfg = configs.get_reduced("qwen3_14b")
    params = model.init_params(cfg, seed=0, device=cuda)
    x = torch.randn(2, 75, cfg.d_model, device=cuda) * 0.5
    ops.reset_launches()
    got = attention.attention_forward(params.layers[0].attn, x, cfg)
    assert ops.launches["flash_attention"] == 1
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 75))
    logits, _, _ = prefill(params, {"tokens": toks}, cfg, 80)
    assert ops.launches["flash_attention"] == 1 + cfg.num_layers
    monkeypatch.setattr(attention, "self_attend",
                        chip_smoke.plain_self_attend)
    want = attention.attention_forward(params.layers[0].attn, x, cfg)
    plain_logits, _, _ = prefill(params, {"tokens": toks}, cfg, 80)
    assert ops.launches["flash_attention"] == 1 + cfg.num_layers
    _close(got, want, 2e-5)
    _close(logits, plain_logits, 1e-4)


def test_serve_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of the reduced fp32 qwen3-14b with block prefill, on
    the card (kernel) and on the CPU (plain attention)."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serving import Request, ServeEngine
    cfg = configs.get_reduced("qwen3_14b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (70, 9, 130)]
    out = {}
    for device in ("cpu", cuda):
        eng = ServeEngine(cfg, model.init_params(cfg, seed=0, device="cpu"),
                          max_batch=2, max_len=160, block_prefill=True,
                          device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        out[str(device)] = {r: q.generated for r, q in eng.run().items()}
    assert out["cpu"] == out[str(cuda)]


# --------------------------------------------------------------------------
# ssd_scan and the mamba2 serving path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.SSD_CASES)
def test_ssd_scan_matches_plain(cuda, case, dtype):
    """The shapes and limits of chip_smoke.py: y fp32 within 5e-5, bf16
    within one bf16 ulp of the plain y; the fp32 final state within
    5e-5 (1 + |s_plain|); mamba2-370m's shapes go in as the model's strided
    slices of one conv output (1999: a ragged last chunk)."""
    args = chip_smoke.ssd_inputs(torch, case, dtype, cuda, seed=1)
    chunk = case[5]
    before = ops.launches["ssd_scan"]
    got = ops.ssd_scan(*args, chunk=chunk)
    assert ops.launches["ssd_scan"] == before + 1
    want = ref.ssd_scan(*args, chunk=chunk)
    assert got[0].dtype == args[0].dtype and got[0].shape == want[0].shape
    assert got[1].dtype == torch.float32 and got[1].shape == want[1].shape
    (_, y_share), (_, s_share) = chip_smoke.ssd_deviation(torch, got, want,
                                                          dtype)
    assert y_share <= 1.0 and s_share <= 1.0


def test_ssd_scan_raises_on_bad_operands_and_without_its_library(
        cuda, monkeypatch, tmp_path):
    """A CUDA tensor gets the kernel or an error — never the plain
    version: bad operands raise before launch, and so does a missing
    library."""
    from repro_torch.kernels import build
    args = chip_smoke.ssd_inputs(torch, (1, 70, 2, 8, 16, 16), "float32",
                                 cuda, seed=2)
    before = dict(ops.launches)
    for bad, err in (
            (dict(chunk=12), ValueError),
            (dict(chunk=256), ValueError),
            (dict(args=(args[0].double(), *args[1:])), TypeError),
            (dict(args=(args[0], args[1].cpu(), *args[2:])), ValueError),
            (dict(args=(args[0].transpose(2, 3), *args[1:])), ValueError)):
        with pytest.raises(err):
            ops.ssd_scan(*bad.get("args", args), chunk=bad.get("chunk", 16))
    monkeypatch.setitem(build.SOURCES, "ssd_scan", tmp_path / "missing.cu")
    monkeypatch.delitem(build._loaded, "ssd_scan", raising=False)
    ops._ssd_lib.cache_clear()
    try:
        with pytest.raises((OSError, RuntimeError)):
            ops.ssd_scan(*args, chunk=16)
    finally:
        ops._ssd_lib.cache_clear()
    assert ops.launches == before


def test_mamba2_prefill_launches_the_kernel_once_per_layer(cuda,
                                                           monkeypatch):
    """Full-width mamba2-370m (48 layers, bf16): a block prefill launches
    ssd_scan 48 times and no flash_attention; its logits and seeded SSM
    state agree with the plain scan swapped in (chip_smoke.py's bf16
    model limit)."""
    from repro_torch import configs
    from repro_torch.models import model
    cfg = configs.get("mamba2_370m")
    params = model.init_params(cfg, seed=0, device=cuda)
    ops.reset_launches()
    dev, _, sdev = chip_smoke.ssd_vs_plain_in_model(
        torch, ops, cfg, params, label="mamba2-370m bf16", prompt=300,
        tol=chip_smoke.MAMBA_TOL["bfloat16"])
    assert ops.launches["ssd_scan"] == cfg.num_layers
    assert ops.launches["flash_attention"] == 0


def test_mamba2_serve_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of the reduced fp32 mamba2-370m with block prefill, on
    the card (kernel at chunk 16, ragged tails) and on the CPU (plain
    ssd_chunked at JAX's chunk), across a reused slot."""
    from repro_torch import configs
    from repro_torch.models import model
    from repro_torch.serving import Request, ServeEngine
    cfg = configs.get_reduced("mamba2_370m")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (70, 9, 131)]
    out = {}
    for device in ("cpu", cuda):
        eng = ServeEngine(cfg, model.init_params(cfg, seed=0, device="cpu"),
                          max_batch=2, max_len=160, block_prefill=True,
                          device=device)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=6))
        out[str(device)] = {r: q.generated for r, q in eng.run().items()}
    assert out["cpu"] == out[str(cuda)]
