"""``kernels/ssm_decode`` as far as the CPU can hold it.

Its plain version (``ref.ssm_decode_ref``, the CPU path of ``ops.ssm_decode``) is the Mamba2
decode step's recurrence as ``Mamba2Mixer.decode`` wrote it inline, bit for bit, at one and two
B/C groups; the dispatcher takes the plain path on the CPU, writes the new state where it is
told (another tensor, or the state itself) and refuses a call that would record a
gradient; the kernel's wrapper refuses CPU tensors before it looks for a compiler; the kernel's
schedule of y's sums, mirrored in float32, lies within the kernel's stated tolerance of the
exact sum; on the card (stood in for by fake tensors) the dispatcher launches the kernel or
refuses the call, never the plain step; a sharded Mixer's decode goes through it as an
unsharded one's does; ``decode_step`` writes the same bits whether it allocates the new state,
writes it into ``out=`` or in place, leaves its input as it was without ``out=``, and hands
each Mamba2 layer's dispatch its row of the new state; and
``bench/metrics/ssm_decode_roofline.serve.py`` reads hand-built traces.  The kernel itself runs
on the card: ``tests/test_torch_gpu.py``.
"""
from pathlib import Path

import pytest
import torch
from torch._subclasses import FakeTensorMode
from torch.utils._pytree import tree_map

from repro_torch.configs import ARCHS
from repro_torch.kernels.ssm_decode import kernel, ops
from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
from repro_torch.models import ssm, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import tp
from test_torch_granite import ARCH as GRANITE_TINY
from test_torch_zamba2 import ARCH as ZAMBA2_TINY

ROOT = Path(__file__).resolve().parents[1]
B, H, P, N = 3, 4, 8, 16


def _inputs(g=1, dtype=torch.float32, b=B, h=H, p=P, n=N, seed=0):
    gen = torch.Generator().manual_seed(seed)
    state = torch.randn(b, h, p, n, generator=gen)
    x = torch.randn(b, h, p, generator=gen).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, h, generator=gen))
    a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h)))
    bvec, cvec = (torch.randn(b, g, n, generator=gen).to(dtype) for _ in range(2))
    return state, x, dt, a, bvec, cvec


def _inline_step(state, x, dt, a, bvec, cvec):
    """``Mamba2Mixer.decode``'s recurrence as it stood inline, before it moved to ``ref.py``."""
    h, g = state.shape[1], bvec.shape[1]
    decay = torch.exp(a[None] * dt)  # (B,H)
    rep = h // g
    bvec_h = bvec.repeat_interleave(rep, dim=1).to(torch.float32)  # (B,H,N)
    cvec_h = cvec.repeat_interleave(rep, dim=1).to(torch.float32)
    dx = dt[..., None] * x.to(torch.float32)  # (B,H,P)
    new = state * decay[..., None, None] + dx[..., None] * bvec_h[:, :, None, :]
    return new, torch.einsum("bhpn,bhn->bhp", new, cvec_h)


# ------------------------------------------------------------ the plain version
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_ref_is_the_mixers_inline_step_bit_for_bit(g, dtype):
    ins = _inputs(g, dtype)
    new, y = ssm_decode_ref(*ins)
    want_new, want_y = _inline_step(*ins)
    assert new.dtype == y.dtype == torch.float32 and y.shape == (B, H, P)
    assert torch.equal(new, want_new) and torch.equal(y, want_y)


@pytest.mark.parametrize("g", [1, 2])
def test_group_of_a_head_is_h_over_heads_per_group(g):
    """Head h reads B and C of group h // (H / G): changing group 1's B moves only the heads
    that read it."""
    state, x, dt, a, bvec, cvec = _inputs(g)
    other = bvec.clone()
    other[:, g - 1] += 1.0
    moved = (ssm_decode_ref(state, x, dt, a, other, cvec)[0] != ssm_decode_ref(state, x, dt, a, bvec, cvec)[0])
    heads = moved.flatten(2).any(-1).any(0)
    assert heads.tolist() == [h // (H // g) == g - 1 for h in range(H)]


@pytest.mark.parametrize("into", ["given", "state"])
def test_ops_on_the_cpu_takes_the_plain_path_into_its_destination(into):
    """CPU tensors run ``ssm_decode_ref`` (no launch counted) and its new state lands in ``out``:
    another tensor, or the state itself, updated in place."""
    state, *rest = _inputs(2)
    want_new, want_y = ssm_decode_ref(state, *rest)
    out = torch.full_like(state, 7.0) if into == "given" else state
    launches = ops.LAUNCHES
    new, y = ops.ssm_decode(state, *rest, out=out)
    assert ops.LAUNCHES == launches
    assert new is out and torch.equal(new, want_new) and torch.equal(y, want_y)


@pytest.mark.parametrize("which", ["state", "x", "B"])
def test_ops_refuses_a_call_that_records_a_gradient(which):
    state, x, dt, a, bvec, cvec = _inputs()
    ins = {"state": state, "x": x, "B": bvec}
    ins[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.ssm_decode(state, x, dt, a, bvec, cvec, out=torch.empty_like(state))
    with torch.inference_mode():
        ops.ssm_decode(*(t.detach() for t in (state, x, dt, a, bvec, cvec)), out=torch.empty_like(state))


def test_kernel_wrapper_refuses_cpu_tensors_before_any_build(monkeypatch):
    """The launcher checks devices before it looks for ``nvcc``: CPU tensors are a fault."""
    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(kernel, "build", no_build)
    state, x, dt, a, bvec, cvec = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssm_decode_cuda(state, x, dt, a, bvec, cvec, state)


# ------------------------------------------------- the kernel's sums, mirrored
def _kernel_y(new, cvec_h):
    """y as the kernel sums it, in float32: thread ``lane`` of a row's ``lanes`` holds the columns
    (j * lanes + lane) * 4 + e, sums them in order of j then e (one rounding each, as its FMAs
    round once), then the lanes join by an xor butterfly from lanes / 2 down to 1."""
    n = new.shape[-1]
    v = 2 if n == 256 else 1
    lanes = n // (4 * v)
    cols = torch.tensor([[(j * lanes + lane) * 4 + e for j in range(v) for e in range(4)] for lane in range(lanes)])
    prod = (new.double()[..., cols] * cvec_h.double()[:, :, None, cols])  # (B, H, P, lanes, 4V), exact
    acc = torch.zeros(prod.shape[:-1], dtype=torch.float32)
    for k in range(prod.shape[-1]):
        acc = (acc.double() + prod[..., k]).float()
    off = lanes // 2
    while off:
        acc = acc + acc[..., torch.arange(lanes) ^ off]
        off //= 2
    return acc[..., 0]


@pytest.mark.parametrize("n", [16, 64, 128, 256])
def test_kernels_sum_order_lies_within_its_stated_tolerance(n):
    """The kernel's y, mirrored, lies within 1e-5 x sum |new * C| of the exact sum, as its note
    states; the new state is the plain version's bits whatever the order of y's sums."""
    state, x, dt, a, bvec, cvec = _inputs(2, torch.bfloat16, n=n, seed=n)
    new, y = ssm_decode_ref(state, x, dt, a, bvec, cvec)
    cvec_h = cvec.repeat_interleave(H // 2, dim=1).float()
    exact = torch.einsum("bhpn,bhn->bhp", new.double(), cvec_h.double())
    scale = torch.einsum("bhpn,bhn->bhp", new.double().abs(), cvec_h.double().abs())
    got = _kernel_y(new, cvec_h)
    assert ((got.double() - exact).abs() <= 1e-5 * scale).all()
    assert ((y.double() - exact).abs() <= 1e-5 * scale).all()


# ------------------------------------------------------------------ the seam
def _mixer(n=N, tp_group=None):
    cfg = ArchConfig(name="ssm-decode-test", family="ssm", num_layers=1, d_model=16, vocab_size=16, ssm_state=n,
                     ssm_expand=2, ssm_head_dim=8, ssm_conv_width=4, ssm_chunk=8, param_dtype="float32",
                     compute_dtype="bfloat16")
    m = ssm.Mamba2Mixer(cfg, torch.Generator().manual_seed(0), "cpu")
    m.tp_group = tp_group
    return m


class Launched(Exception):
    """Raised in place of the kernel's build: the call reached the launch."""


def _dispatch(monkeypatch, *, device="cuda", state_dtype=torch.float32, x_dtype=torch.bfloat16, out_dtype=None,
              p=8, n=N, strided=False):
    """What ``ops.ssm_decode`` does with a call of these tensors (fake ones, so a CUDA call needs
    no card): ``"kernel"`` (it reached the launch), ``"plain"`` or ``"refused"``."""
    def launched():
        raise Launched

    monkeypatch.setattr(kernel, "build", launched)
    with FakeTensorMode():
        state = torch.empty(B, 4, p, n, dtype=state_dtype, device=device)
        x = torch.empty(B, 4, p, dtype=x_dtype, device=device)
        dt, a = torch.empty(B, 4, device=device), torch.empty(4, device=device)
        bvec, cvec = (torch.empty(B, 1, n, dtype=x_dtype, device=device) for _ in range(2))
        shape, dst_dtype = ((B, 4, n, p) if strided else (B, 4, p, n)), out_dtype or state_dtype
        dst = torch.empty(shape, dtype=dst_dtype, device=device)
        try:
            ops.ssm_decode(state, x, dt, a, bvec, cvec, out=dst.transpose(2, 3) if strided else dst)
        except Launched:
            return "kernel"
        except ValueError:
            return "refused"
        return "plain"


CALLS = {
    "fits": {},
    "float32-x": {"x_dtype": torch.float32},
    "cpu": {"device": "cpu"},
    "float64-destination": {"out_dtype": torch.float64},
    "float64-state": {"state_dtype": torch.float64},
    "float16-x": {"x_dtype": torch.float16},
    "strided-destination": {"strided": True},
    "state-12": {"n": 12},
    "state-512": {"n": 512},
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_kernel_path_is_chosen_by_what_the_call_observes(monkeypatch, call):
    """On the card, a float32 state and a contiguous float32 destination, x in float32 or bfloat16, and
    N in the kernel's sizes: the kernel; anything else on the card is refused, never handed to the
    plain step; CPU tensors take the plain step."""
    want = {"fits": "kernel", "float32-x": "kernel", "cpu": "plain"}.get(call, "refused")
    assert _dispatch(monkeypatch, **CALLS[call]) == want


def test_sharded_decode_goes_through_the_dispatcher(monkeypatch):
    """A Mixer with a ``tp_group`` (one rank, whose collectives are the identity) hands its
    rank's heads to ``ops.ssm_decode`` as an unsharded one does, with the same bits."""
    monkeypatch.setattr(tp, "_all_reduce", lambda x, g, op="sum": x)
    monkeypatch.setattr(tp, "_all_gather", lambda x, dim, g: x)
    calls = []
    real = ops.ssm_decode

    def counting(state, *args, out):
        calls.append(state.shape)
        return real(state, *args, out=out)

    monkeypatch.setattr(ssm.ssm_decode_ops, "ssm_decode", counting)
    xin = torch.randn(B, 1, 16, generator=torch.Generator().manual_seed(2))
    got = []
    for group in (None, tp.Group(group=None, rank=0, size=1)):
        mixer = _mixer(tp_group=group)
        cache = mixer.init_cache(B, torch.bfloat16)
        cache["state"].normal_(generator=torch.Generator().manual_seed(3))
        with torch.inference_mode():
            got.append(mixer.decode(xin, cache, out=torch.empty_like(cache["state"])))
    assert calls == [(B, 4, 8, N)] * 2
    (y0, c0), (y1, c1) = got
    assert torch.equal(y0, y1) and torch.equal(c0["state"], c1["state"]) and torch.equal(c0["conv"], c1["conv"])


# -------------------------------------------------------------- decode_step
TINY = {ZAMBA2_TINY["name"]: ZAMBA2_TINY, GRANITE_TINY["name"]: GRANITE_TINY}
NAMES = ["mamba2-780m", "zamba2-2.7b", ZAMBA2_TINY["name"], GRANITE_TINY["name"]]  # ssm, hybrid, zamba2, granite


def _primed(name):
    cfg = ArchConfig(**TINY[name]) if name in TINY else ARCHS[name].reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    logits, cache = transformer.prefill(cfg, params, {"tokens": prompts}, 16)
    return cfg, params, cache, logits[:, -1].argmax(-1).to(torch.int32)[:, None]


@pytest.mark.parametrize("into", ["given", "input"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_writes_the_same_bits_allocating_given_or_in_place(name, into):
    """The new state and every other leaf are the same bits whether ``decode_step`` allocates
    them, writes them into a given cache or into its input; without ``out=`` the input cache is
    left as it was."""
    cfg, params, cache, tok = _primed(name)
    before = [t.clone() for t in transformer._leaves(cache)]
    want_logits, want = transformer.decode_step(cfg, params, cache, tok)
    assert all(torch.equal(t, b) for t, b in zip(transformer._leaves(cache), before))
    assert not torch.equal(want["ssm"]["state"], cache["ssm"]["state"])
    out = tree_map(lambda t: torch.full_like(t, 7), cache) if into == "given" else cache
    got_logits, got = transformer.decode_step(cfg, params, cache, tok, out=out)
    assert got["ssm"]["state"] is out["ssm"]["state"]
    assert torch.equal(got_logits, want_logits)
    assert all(torch.equal(g, w) for g, w in zip(transformer._leaves(got), transformer._leaves(want)))


@pytest.fixture
def spy(monkeypatch):
    """Records each dispatch's state and destination (on the CPU the dispatcher runs the plain
    version)."""
    calls = []
    real = ops.ssm_decode

    def counting(state, *args, out=None):
        calls.append((state, out))
        return real(state, *args, out=out)

    monkeypatch.setattr(ssm.ssm_decode_ops, "ssm_decode", counting)
    return calls


@pytest.mark.parametrize("into", ["alloc", "input"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_hands_each_mamba2_layer_its_row_of_the_new_state(spy, name, into):
    """Each Mamba2 layer's dispatch reads its row of the old state and writes its row of the new
    one, in order; the step's bits are those of a step on a copy of the cache."""
    cfg, params, cache, tok = _primed(name)
    old = cache["ssm"]["state"]
    want_logits, want = transformer.decode_step(cfg, params, tree_map(torch.clone, cache), tok)
    spy.clear()
    got_logits, got = transformer.decode_step(cfg, params, cache, tok, out=cache if into == "input" else None)
    new = got["ssm"]["state"]
    rows = transformer.ssm_rows(cfg)
    assert len(spy) == rows
    assert all(s.data_ptr() == old[r].data_ptr() and o.data_ptr() == new[r].data_ptr() and o.shape == new[r].shape
               for r, (s, o) in enumerate(spy))
    assert (new is old) is (into == "input")
    assert torch.equal(got_logits, want_logits)
    assert all(torch.equal(g, w) for g, w in zip(transformer._leaves(got), transformer._leaves(want)))


# ------------------------------------------------------- the benchmark's reader
@pytest.fixture
def roofline(monkeypatch):
    """``ssm_decode_roofline.serve``'s reader over a hand-built trace of kernel times."""
    monkeypatch.syspath_prepend(str(ROOT))  # bench/ lives at the root
    from bench.harness import cell as cellmod
    from bench.harness.run_state import Run
    from bench.harness.spans import Spans
    from bench.harness.trace import Trace

    read = cellmod.reader("ssm_decode_roofline.serve")

    def of(cell, kernel_s, profiled):
        trace = Trace(window_s=10.0, busy_s=9.0, kernel_s=kernel_s)
        return read(Run(spans=Spans(sync=False, device_type="cpu"), trace=trace, info={"profiled": profiled}), cell)

    return cellmod.load, of


# cell: (Mamba2 layers, heads, groups, state size), P 64 and bf16 in all three
SHAPES = {"mamba2-780m.chat": (48, 48, 1, 128), "zamba2-7b-instruct.chat": (81, 112, 2, 64),
          "granite-4.0-h-small.chat": (36, 128, 1, 128)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_roofline_counts_each_steps_state_read_and_written(roofline, name):
    """63 steps x the Mamba2 layers x 32 rows x (the f32 state read and written, x read and y
    written in bf16, B and C a group in bf16, dt in f32), at 3.35 TB/s, over the kernel's time."""
    load, read = roofline
    cell = load(name)
    layers, h, g, n = SHAPES[name]
    steps = cell.mix["new_tokens"] - 1
    nbytes = steps * layers * 32 * (2 * h * 64 * n * 4 + 2 * h * 64 * 2 + 2 * g * n * 2 + h * 4)
    least = nbytes / 3.35e12
    times = {"void (anonymous namespace)::ssm_decode_kernel<__nv_bfloat16, 1>(...)": least,
             "elementwise_kernel": 5.0, "decode_attention_chunk": 1.0}
    assert read(cell, times, {"batch": 32, "seq_len": 1024}) == pytest.approx(100.0)
    assert read(cell, times, {"batch": 16, "seq_len": 1024}) == pytest.approx(50.0)


@pytest.mark.parametrize("kernel_s,profiled", [
    ({"elementwise_kernel": 1.0, "CatArrayBatchedCopy": 2.0}, {"batch": 32, "seq_len": 1024}),  # plain path
    ({"ssm_decode_kernel": 1.0}, None),                                                         # not profiled
], ids=["no-kernel", "no-profiled-batch"])
def test_roofline_without_the_kernel_gives_nothing(roofline, kernel_s, profiled):
    load, read = roofline
    assert read(load("mamba2-780m.chat"), kernel_s, profiled) is None
