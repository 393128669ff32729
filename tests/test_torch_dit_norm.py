"""Kernel D (ops/dit_norm.py, csrc/dit_norm.cu): the DiT layer's AdaLN and
Q/K-norm-with-RoPE islands.

On the CPU: the plain versions equal the compositions the DiT layer ran
before (low_rank_adaln's normalisation; rms_norm then
apply_rotary_emb_half_heads) bit for bit, a CPU layer runs them with or
without autograd, a card's layer under autograd launches the kernel with
the plain version's gradients, and the wrappers refuse shapes, dtypes and
layouts the kernel does not take.  On a card (skipped without one): the
kernel against its plain version within rel-RMS 1e-4 (bf16 against the
same bf16 composition; only the fp32 sum of squares runs in another
order), at the main path's shapes, with and without grad, and its launch
count under CUDA-graph replay.  Imports nothing of JAX, so that on the
card's machine it runs as

    python -m pytest --noconftest tests/test_torch_dit_norm.py
"""
import pytest
import torch
import torch.nn.functional as F

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.ops import dit_norm
from echo_tts_torch.ops.norms import (LowRankAdaLN, adaln_conditioning,
                                      low_rank_adaln, rms_norm)
from echo_tts_torch.ops.rope import (apply_rotary_emb_half_heads,
                                     freqs_tensor, rotated_heads)

torch.set_num_threads(1)
EPS = 1e-5
# kernel D against its plain version: the same roundings, the fp32 sum of
# squares in another order; dropping one rounding (scale + 1 to bf16, the
# norm to bf16 before RoPE) moves the output by about 1e-3
KERNEL_REL_RMS_BOUND = 1e-4
# a whole captured DiT forward against its eager run, whose library GEMMs
# may differ (PARITY.md: bf16 against fp32 1.05e-2)
FORWARD_REL_RMS_BOUND = 1e-2


def _todays_adaln(x, cond_embed, p, eps):
    """low_rank_adaln as the DiT layer ran it before kernel D."""
    shift, scale, gate = torch.chunk(cond_embed, 3, dim=-1)

    def refine(c, down, up):
        return up(down(F.silu(c))) + c

    shift = refine(shift, p.shift_down, p.shift_up)
    scale = refine(scale, p.scale_down, p.scale_up)
    gate = refine(gate, p.gate_down, p.gate_up)
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xf = xf * (scale + 1) + shift
    return xf.to(dtype), torch.tanh(gate)


def _gathered_freqs(dh, s, start):
    """The query table as the forward's _embed gathers it: rows start + i."""
    rows = start + torch.arange(s)
    return freqs_tensor(dh, start + s, "cpu").index_select(0, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adaln_plain_is_the_layers_composition(dtype):
    """dit_adaln_plain (and dit_adaln on the CPU) after the conditioning
    equals low_rank_adaln as the DiT layer ran it, bit for bit."""
    g = torch.Generator().manual_seed(0)
    m = 64
    p = LowRankAdaLN(m, 8).to(dtype)
    tdit.init_random_(p, g)
    x = torch.randn((3, 10, m), generator=g).to(dtype)
    cond = torch.randn((3, 1, 3 * m), generator=g).to(dtype)
    want, want_gate = _todays_adaln(x, cond, p, EPS)
    shift, scale, gate = adaln_conditioning(cond, p)
    for got in (dit_norm.dit_adaln_plain(x, shift, scale, EPS),
                dit_norm.dit_adaln(x, shift, scale, EPS),
                low_rank_adaln(x, cond, p, EPS)[0]):
        assert got.dtype == dtype
        assert torch.equal(got, want)
    assert torch.equal(gate, want_gate)


@pytest.mark.parametrize("heads,offset,num_heads,start", [
    (16, 0, 16, 0),      # whole: the first 8 heads rotated
    (8, 0, 16, 0),       # a TP shard's first half: all 8 rotated
    (8, 8, 16, 0),       # its second half: none rotated
    (16, 0, 16, 280),    # a block's gathered table at a nonzero start
    (8, 0, 16, 40),
])
def test_qk_plain_is_the_layers_composition(heads, offset, num_heads, start):
    """qk_norm_rope_plain (and qk_norm_rope on the CPU) at n =
    rotated_heads equals rms_norm then apply_rotary_emb_half_heads, as
    the layer ran them, bit for bit, in bf16 and fp32."""
    g = torch.Generator().manual_seed(1)
    gb, s, dh = 3, 12, 16
    n = rotated_heads(heads, offset, num_heads)
    freqs = _gathered_freqs(dh, s, start)
    for dtype in (torch.bfloat16, torch.float32):
        q, k = (torch.randn((gb, s, heads, dh), generator=g).to(dtype)
                for _ in range(2))
        wq, wk = ((1 + 0.1 * torch.randn((heads, dh), generator=g)).to(dtype)
                  for _ in range(2))
        want = [apply_rotary_emb_half_heads(rms_norm(x, w, EPS), freqs,
                                            offset, num_heads)
                for x, w in ((q, wq), (k, wk))]
        for got in (dit_norm.qk_norm_rope_plain(q, k, wq, wk, freqs, n, EPS),
                    dit_norm.qk_norm_rope(q, k, wq, wk, freqs, n, EPS)):
            for a, b in zip(got, want):
                assert a.dtype == dtype and torch.equal(a, b)


def _layer_inputs(cfg, gb=3, b=1, s=8, t=12, seed=2):
    g = torch.Generator().manual_seed(seed)
    h, dh, m = cfg.num_heads, cfg.head_dim, cfg.model_size
    return dict(
        h=torch.randn((gb, s, m), generator=g),
        cond=torch.randn((gb, 1, 3 * m), generator=g),
        freqs_q=_gathered_freqs(dh, s, 0),
        static_mask=torch.rand((gb, t), generator=g) < 0.8,
        col_scale=None,
        k_st=torch.randn((b, t, h, dh), generator=g),
        v_st=torch.randn((b, t, h, dh), generator=g))


@pytest.fixture
def routed(monkeypatch):
    """Treat CPU tensors as the card's, with each kernel launch recorded
    and answered by its plain version: which calls reach the kernel."""
    calls = []

    def adaln(x, shift, scale, eps):
        calls.append("adaln")
        return dit_norm.dit_adaln_plain(x, shift, scale, eps)

    def qk(q, k, wq, wk, freqs, n, eps):
        calls.append("qk")
        return dit_norm.qk_norm_rope_plain(q, k, wq, wk, freqs, n, eps)

    monkeypatch.setattr(dit_norm, "_on_card", lambda x: True)
    monkeypatch.setattr(dit_norm, "_launch_adaln", adaln)
    monkeypatch.setattr(dit_norm, "_launch_qk_rope", qk)
    return calls


def _layer(blk, cfg, inp):
    return tdit._dit_layer(blk, inp["h"], inp["cond"], inp["freqs_q"],
                           inp["static_mask"], inp["col_scale"], inp["k_st"],
                           inp["v_st"], cfg=cfg)


def _layer_grads(blk, cfg, inp):
    """The layer's output under grad, and every parameter's gradient of
    its squares' sum."""
    blk.zero_grad()
    out = _layer(blk, cfg, inp)
    out.square().sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in blk.named_parameters()
                          if p.grad is not None}


def test_dit_layer_under_grad_takes_the_plain_path(routed):
    """On the CPU a trainable layer under grad runs the plain composition
    (the train graph is what it was): no launch, and its output and
    gradients those of the plain versions in the kernel's place."""
    from echo_tts_torch.models.plain import plain_kernels
    cfg = tiny_dit_config()
    model = tdit.trainable_copy(
        tdit.init_dit(cfg, device="cpu", dtype=torch.float32, seed=4))
    blk, inp = model.blocks[0], _layer_inputs(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dit_norm, "_on_card", lambda x: False)
        out, grads = _layer_grads(blk, cfg, inp)
    assert routed == [] and grads
    with plain_kernels():
        want, want_grads = _layer_grads(blk, cfg, inp)
    assert routed == [] and torch.equal(out, want)
    assert want_grads.keys() == grads.keys()
    assert all(torch.equal(want_grads[n], grads[n]) for n in grads)


def test_dit_layer_under_grad_on_the_card_launches_with_plain_grads(routed):
    """On a card a trainable layer under grad launches the kernel in its
    forward, two AdaLN and one Q/K call, and none in its backward, which
    recomputes through the plain versions: its gradients are the plain
    composition's (here the launch answers with the plain version), up to
    the order in which the layer sums the four projections' gradients of
    the normalised input (the Q/K island hands back both of its at once);
    the same layer without grad launches the same three."""
    cfg = tiny_dit_config()
    model = tdit.trainable_copy(
        tdit.init_dit(cfg, device="cpu", dtype=torch.float32, seed=4))
    blk, inp = model.blocks[0], _layer_inputs(cfg)
    out, grads = _layer_grads(blk, cfg, inp)
    assert routed == ["adaln", "qk", "adaln"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dit_norm, "_on_card", lambda x: False)
        want, want_grads = _layer_grads(blk, cfg, inp)
    assert torch.equal(out, want)
    assert want_grads.keys() == grads.keys()
    for n in grads:
        torch.testing.assert_close(grads[n], want_grads[n], rtol=1e-5,
                                   atol=1e-6 * float(want_grads[n].abs().max()))
    with torch.no_grad():
        again = _layer(blk, cfg, inp)
    assert routed == ["adaln", "qk", "adaln"] * 2
    assert torch.equal(again, out)


@pytest.mark.parametrize("needs", ["all", "activations", "weights"])
def test_islands_under_grad_carry_the_plain_gradients(routed, needs):
    """Each island alone under autograd on a card: the kernel once, and
    the plain version's gradient for exactly the inputs that require
    one."""
    g = torch.Generator().manual_seed(3)
    gb, s, h, dh, m = 2, 6, 4, 16, 64
    n = rotated_heads(h)
    freqs = _gathered_freqs(dh, s, 40)
    acts = [torch.randn((gb, s, m), generator=g),
            torch.randn((gb, s, h, dh), generator=g),
            torch.randn((gb, s, h, dh), generator=g)]
    weights = [torch.randn((gb, 1, m), generator=g),
               torch.randn((gb, 1, m), generator=g),
               1 + 0.1 * torch.randn((h, dh), generator=g),
               1 + 0.1 * torch.randn((h, dh), generator=g)]
    for x in (acts if needs != "weights" else []) + (
            weights if needs != "activations" else []):
        x.requires_grad_()
    x, q, k = acts
    shift, scale, wq, wk = weights
    leaves = [t for t in acts + weights if t.requires_grad]

    def grads_of(adaln, qk):
        out = adaln(x, shift, scale, EPS)
        qo, ko = qk(q, k, wq, wk, freqs, n, EPS)
        loss = (out.square().sum() + (qo * ko).sum()
                + qo.sin().sum() + ko.cos().sum())
        return [out, qo, ko], torch.autograd.grad(loss, leaves)

    got, got_grads = grads_of(dit_norm.dit_adaln, dit_norm.qk_norm_rope)
    assert routed == ["adaln", "qk"]
    want, want_grads = grads_of(dit_norm.dit_adaln_plain,
                                dit_norm.qk_norm_rope_plain)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    assert routed == ["adaln", "qk"]


def test_frozen_layer_under_grad_mode_reaches_the_kernel(routed):
    """Grad mode on but nothing requiring grad (a frozen teacher, as the
    distill step runs it): the kernel, as kernel A is taken."""
    cfg = tiny_dit_config()
    model = tdit.init_dit(cfg, device="cpu", dtype=torch.float32, seed=5)
    with torch.enable_grad():
        _layer(model.blocks[1], cfg, _layer_inputs(cfg))
    assert routed == ["adaln", "qk", "adaln"]


def test_plain_kernels_keep_fp32_oracles_off_the_kernel(routed):
    """models.plain.plain_kernels, under which the checks run fp32 copies
    of the DiT on the card, routes the norm islands to their plain
    versions too, and restores the kernel after."""
    from echo_tts_torch.models.plain import plain_kernels
    cfg = tiny_dit_config()
    model = tdit.init_dit(cfg, device="cpu", dtype=torch.float32, seed=5)
    inp = _layer_inputs(cfg)
    with torch.no_grad():
        with plain_kernels():
            _layer(model.blocks[0], cfg, inp)
        assert routed == []
        _layer(model.blocks[0], cfg, inp)
    assert routed == ["adaln", "qk", "adaln"]


def test_kernel_refuses_layouts_it_does_not_read():
    """A tensor that is not contiguous, or whose base is not 16-byte
    aligned, is refused before anything is launched, not copied."""
    bf = torch.bfloat16
    x, cond = torch.zeros((2, 4, 64), dtype=bf), torch.zeros((2, 1, 64),
                                                              dtype=bf)
    strided = torch.zeros((2, 4, 128), dtype=bf)[..., :64]
    shifted = torch.zeros((2 * 4 * 64 + 1,), dtype=bf)[1:].view(2, 4, 64)
    for bad in (strided, shifted):
        with pytest.raises(ValueError, match="contiguous"):
            dit_norm._launch_adaln(bad, cond, cond, EPS)
    with pytest.raises(ValueError, match=r"\['shift'\]"):
        dit_norm._launch_adaln(x, torch.zeros((2, 1, 128), dtype=bf)[..., :64],
                               cond, EPS)
    q = torch.zeros((2, 4, 8, 128), dtype=bf)
    w = torch.ones((8, 128), dtype=bf)
    freqs = torch.zeros((4, 64, 2))
    q_t = torch.zeros((2, 8, 4, 128), dtype=bf).transpose(1, 2)
    with pytest.raises(ValueError, match=r"\['k'\]"):
        dit_norm._launch_qk_rope(q, q_t, w, w, freqs, 4, EPS)
    with pytest.raises(ValueError, match=r"\['freqs'\]"):
        dit_norm._launch_qk_rope(q, q, w, w,
                                 torch.zeros((4, 64, 3))[..., :2], 4, EPS)


@pytest.mark.parametrize("case", ["x_rank", "shift_batch", "scale_shape"])
def test_adaln_checks_shapes(case):
    x = torch.zeros((2, 4, 16))
    shift = scale = torch.zeros((2, 1, 16))
    if case == "x_rank":
        x = x[0]
    elif case == "shift_batch":
        shift = torch.zeros((1, 1, 16))
    else:
        scale = torch.zeros((2, 4, 16))
    with pytest.raises(ValueError, match="shift"):
        dit_norm.dit_adaln(x, shift, scale, EPS)


@pytest.mark.parametrize("case", ["k_shape", "weight", "freqs", "n_high",
                                  "n_negative"])
def test_qk_checks_shapes(case):
    q = k = torch.zeros((2, 4, 8, 16))
    wq = wk = torch.ones((8, 16))
    freqs = torch.zeros((4, 8, 2))
    n = 4
    if case == "k_shape":
        k = torch.zeros((2, 4, 4, 16))
    elif case == "weight":
        wk = torch.ones((16,))
    elif case == "freqs":
        freqs = torch.zeros((5, 8, 2))
    else:
        n = 9 if case == "n_high" else -1
    with pytest.raises(ValueError, match="Dh"):
        dit_norm.qk_norm_rope(q, k, wq, wk, freqs, n, EPS)


def test_kernel_checks_dtypes_head_dim_and_device():
    """What the kernel refuses is refused before anything is launched:
    float32 activations or weights, a float RoPE table that is not fp32,
    a head dim other than 128, a model size it cannot hold in registers,
    another device than the CPU or CUDA."""
    bf = torch.bfloat16
    x, cond = torch.zeros((2, 4, 64), dtype=bf), torch.zeros((2, 1, 64),
                                                              dtype=bf)
    with pytest.raises(TypeError, match="AdaLN"):
        dit_norm._launch_adaln(x.float(), cond, cond, EPS)
    with pytest.raises(TypeError, match="AdaLN"):
        dit_norm._launch_adaln(x, cond.float(), cond, EPS)
    wide = torch.zeros((1, 1, 8192), dtype=bf)
    with pytest.raises(ValueError, match="model size"):
        dit_norm._launch_adaln(wide, wide, wide, EPS)
    q = torch.zeros((2, 4, 8, 128), dtype=bf)
    w = torch.ones((8, 128), dtype=bf)
    freqs = torch.zeros((4, 64, 2))
    with pytest.raises(TypeError, match="Q/K"):
        dit_norm._launch_qk_rope(q.float(), q, w, w, freqs, 4, EPS)
    with pytest.raises(TypeError, match="Q/K"):
        dit_norm._launch_qk_rope(q, q, w.float(), w, freqs, 4, EPS)
    with pytest.raises(TypeError, match="RoPE"):
        dit_norm._launch_qk_rope(q, q, w, w, freqs.double(), 4, EPS)
    q64, w64 = q[..., :64], w[:, :64]
    with pytest.raises(ValueError, match="head dim"):
        dit_norm._launch_qk_rope(q64, q64, w64, w64, freqs[:, :32], 4, EPS)
    with pytest.raises(ValueError, match="unsupported device"):
        dit_norm.dit_adaln(x.to("meta"), cond.to("meta"), cond.to("meta"),
                           EPS)


def test_counter_is_registered_for_replay():
    from echo_tts_torch.utils import programs
    assert (dit_norm, "launches") in programs._COUNTERS
    from echo_tts_torch.ops import cuda_build
    assert "dit_norm" in cuda_build.KERNELS


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("kernel D runs on a CUDA card")
    return torch.device("cuda")


def _rel_rms(got, want) -> float:
    g, w = got.float(), want.float()
    assert bool(g.isfinite().all())
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


# (GB, S): bulk's q-batch on CFG steps and else (B = 8, 640 latents);
# open's lone request and passes of 2 and 8 on CFG steps (320 latents); a
# block core's blocks of 80 and 320 latents; one request at 640 latents on
# CFG steps and else
SHAPES = [(24, 640), (8, 640), (3, 320), (6, 320), (24, 320), (3, 80),
          (1, 320), (3, 640), (1, 640)]


@pytest.mark.parametrize("gb,s,m", [(gb, s, 2048) for gb, s in SHAPES]
                         + [(2, 33, 1000)])
def test_adaln_kernel_against_plain(card, gb, s, m):
    """At the DiT's width, and at a narrower one whose last chunks each
    lane masks."""
    g = torch.Generator(device=card).manual_seed(gb * 1000 + s)
    x = torch.randn((gb, s, m), generator=g, device=card).to(torch.bfloat16)
    shift = (0.5 * torch.randn((gb, 1, m), generator=g, device=card)
             ).to(torch.bfloat16)
    scale = (0.5 * torch.randn((gb, 1, m), generator=g, device=card)
             ).to(torch.bfloat16)
    before = dit_norm.launches
    got = dit_norm.dit_adaln(x, shift, scale, EPS)
    torch.cuda.synchronize()
    assert dit_norm.launches == before + 1
    assert _rel_rms(got, dit_norm.dit_adaln_plain(x, shift, scale, EPS)) \
        <= KERNEL_REL_RMS_BOUND


@pytest.mark.parametrize("gb,s,heads,offset", [
    (gb, s, 16, 0) for gb, s in SHAPES] + [(3, 640, 8, 0), (3, 640, 8, 8),
                                           (24, 640, 8, 8)])
def test_qk_kernel_against_plain(card, gb, s, heads, offset):
    """Whole heads and a TP = 2 shard's (8 heads at offsets 0 and 8 of
    16), with the table gathered at a block's nonzero start."""
    g = torch.Generator(device=card).manual_seed(gb * 1000 + s + heads)
    dh = 128
    n = rotated_heads(heads, offset, 16)
    rows = 280 + torch.arange(s, device=card)
    freqs = freqs_tensor(dh, 280 + s, card).index_select(0, rows)
    q, k = (torch.randn((gb, s, heads, dh), generator=g, device=card)
            .to(torch.bfloat16) for _ in range(2))
    wq, wk = ((1 + 0.1 * torch.randn((heads, dh), generator=g, device=card))
              .to(torch.bfloat16) for _ in range(2))
    got = dit_norm.qk_norm_rope(q, k, wq, wk, freqs, n, EPS)
    torch.cuda.synchronize()
    want = dit_norm.qk_norm_rope_plain(q, k, wq, wk, freqs, n, EPS)
    for a, b in zip(got, want):
        assert _rel_rms(a, b) <= KERNEL_REL_RMS_BOUND
    # the heads not rotated are rms_norm's output as it is
    if n < heads:
        torch.testing.assert_close(got[0][:, :, n:],
                                   rms_norm(q, wq, EPS)[:, :, n:],
                                   rtol=0.0, atol=0.02)


@pytest.mark.parametrize("gb,s", [(2, 640), (3, 80)])
def test_kernel_under_grad_against_plain(card, gb, s):
    """Under autograd on the card, as the train and distill steps run the
    layer: one launch an island, the outputs within KERNEL_REL_RMS_BOUND
    of the plain version's, and for the same output gradients every
    input's gradient the plain version's bit for bit (the backward is its
    recompute)."""
    g = torch.Generator(device=card).manual_seed(gb * 100 + s)
    bf, m, h, dh = torch.bfloat16, 2048, 16, 128

    def draw(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(shape, generator=g, device=card)
                ).to(bf).requires_grad_()

    x, shift, scale = draw(gb, s, m), draw(gb, 1, m, std=0.5), draw(
        gb, 1, m, std=0.5)
    q, k = draw(gb, s, h, dh), draw(gb, s, h, dh)
    wq, wk = draw(h, dh, std=0.1, mean=1.0), draw(h, dh, std=0.1, mean=1.0)
    freqs = freqs_tensor(dh, s, card)
    leaves = [x, shift, scale, q, k, wq, wk]
    grad_outs = [torch.randn(t.shape, generator=g, device=card).to(bf)
                 for t in (x, q, k)]

    def run(adaln, qk):
        outs = [adaln(x, shift, scale, EPS),
                *qk(q, k, wq, wk, freqs, rotated_heads(h), EPS)]
        return outs, torch.autograd.grad(outs, leaves, grad_outs)

    before = dit_norm.launches
    got, got_grads = run(dit_norm.dit_adaln, dit_norm.qk_norm_rope)
    torch.cuda.synchronize()
    assert dit_norm.launches == before + 2
    want, want_grads = run(dit_norm.dit_adaln_plain,
                           dit_norm.qk_norm_rope_plain)
    for a, b in zip(got, want):
        assert _rel_rms(a.detach(), b.detach()) <= KERNEL_REL_RMS_BOUND
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


def test_launches_are_exact_under_replay(card):
    """A captured DiT forward counts 3 launches a layer on every replay:
    72 a step of the 24-layer DiT (the encoders cut to 2 layers)."""
    from echo_tts_torch.tools.parallel_checks import cut_config
    from echo_tts_torch.utils import programs
    cfg = cut_config(24)
    model = tdit.init_dit(cfg, device=card, seed=6)
    g = torch.Generator(device=card).manual_seed(7)
    gb, s, t = 3, 80, 40
    bf = torch.bfloat16
    kv = [torch.randn((cfg.num_layers, 1, t, cfg.num_heads, cfg.head_dim),
                      generator=g, device=card).to(bf) for _ in range(2)]
    spk = torch.zeros((t,), dtype=torch.bool, device=card)
    mask = torch.ones((gb, t), dtype=torch.bool, device=card)
    x = torch.randn((gb, s, cfg.latent_size), generator=g, device=card).to(bf)
    tt = torch.full((gb,), 0.5, device=card, dtype=bf)

    def body(owner, x, tt, k, v, spk, mask):
        return tdit.dit_forward_static(owner, x, tt, (k, v), spk, mask)

    cache = programs.ProgramCache("test-dit-norm", 2)
    try:
        with torch.inference_mode():
            before = dit_norm.launches
            outs = [cache(("dit",), model, [x, tt, *kv, spk, mask],
                          lambda: body) for _ in range(3)]
            torch.cuda.synchronize()
        assert (cache.misses, cache.hits) == (1, 2)
        assert dit_norm.launches - before == 3 * 72
        # the replays repeat each other; the eager run may differ from them
        # in the library GEMMs' choice under capture, not in kernel D
        assert torch.equal(outs[2], outs[1])
        assert _rel_rms(outs[1], outs[0]) <= FORWARD_REL_RMS_BOUND
    finally:
        programs._CACHES.remove(cache)
