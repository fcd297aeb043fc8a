"""``kernels/decode_attention`` as far as the CPU can hold it.

Its plain version (the CPU path of ``ops.decode_attention``) is ``layers._attend_cache``
over the rows ``max(0, pos - window + 1) .. pos``, bit for bit once through ``wo``, at every
row position, for an identity, a grouped and a padded q-head -> kv-head map, with and
without a window; the kernel's schedule (its chunks, warps, rows in flight, rounds of q heads
and the two joins), mirrored in float32, is the plain version up to the order of the sums;
``attention_decode`` picks the kernel only where the call fits it (on the
card, bfloat16, ``pos`` on the device, no ``tp_group`` or ``seq_split``, a head size the kernel
takes: the card stood in for by fake tensors), and on that path hands the kernel the layer's
map, scale and window; and ``bench/metrics/decode_attention_roofline.serve.py`` reads hand-built
traces.  The kernel itself runs on the card: ``tests/test_torch_gpu.py``.
"""
from pathlib import Path

import pytest
import torch
from torch._subclasses import FakeTensorMode

from repro_torch.kernels.decode_attention import kernel, ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import tp

ROOT = Path(__file__).resolve().parents[1]
SMAX, B, D = 10, 3, 16
MAPS = {"identity": (4, 4, 0), "grouped": (6, 2, 0), "padded": (8, 3, 6)}  # (H, K, orig_num_heads)


def _layer(family="zamba2", mapping="identity", dtype="float32", window=0, head_dim=D):
    h, kh, orig = MAPS[mapping]
    cfg = ArchConfig(name="decode-attention-test", family=family, num_layers=1, d_model=24, vocab_size=16,
                     num_heads=h, num_kv_heads=kh, head_dim=head_dim, orig_num_heads=orig, sliding_window=window,
                     param_dtype=dtype, compute_dtype=dtype)
    return cfg, layers.Attention(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(False)


def _qkv(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, cfg.compute_dtype)
    q = torch.randn(B, 1, cfg.num_heads, D, generator=g).to(dt)
    k, v = (torch.randn(B, SMAX, cfg.num_kv_heads, D, generator=g).to(dt) for _ in range(2))
    return q, k, v


def _valid(pos, window):
    kpos = torch.arange(SMAX)[None, :]
    valid = kpos <= pos
    if window:
        valid &= kpos > pos - window
    return valid


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("mapping", sorted(MAPS))
@pytest.mark.parametrize("pos", range(SMAX))
def test_plain_version_is_attend_cache(pos, mapping, window):
    """Through ``wo``, ``ops.decode_attention`` on CPU tensors at a device-style 0-d ``pos`` is
    ``_attend_cache`` with ``valid = kpos <= pos`` (and inside the window), bit for bit; an int
    ``pos`` gives the same bits."""
    cfg, p = _layer(mapping=mapping, window=window)
    q, k, v = _qkv(cfg, seed=pos)
    want = layers._attend_cache(cfg, p, q, k, v, _valid(pos, window))
    scale = layers.softmax_scale(cfg, D)
    for at in (torch.tensor(pos, dtype=torch.int32), pos):
        out = ops.decode_attention(q, k, v, p.kvm, at, scale=scale, window=window)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert torch.equal(torch.einsum("bshk,hkd->bsd", out, p.wo), want)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("mapping", sorted(MAPS))
@pytest.mark.parametrize("pos", [0, 4, SMAX - 1])
def test_plain_version_reads_only_the_rows_attended(pos, mapping, window):
    """Rows after ``pos``, or before the window, change nothing: rewriting them with other
    finite values leaves the output's bits as they were (the kernel never loads them)."""
    cfg, p = _layer(mapping=mapping, window=window)
    q, k, v = _qkv(cfg)
    at = torch.tensor(pos, dtype=torch.int32)
    before = decode_attention_ref(q, k, v, p.kvm, at, scale=0.25, window=window)
    outside = ~_valid(pos, window)[0]
    k[:, outside], v[:, outside] = 1e4, -1e4
    assert torch.equal(decode_attention_ref(q, k, v, p.kvm, at, scale=0.25, window=window), before)


# ---------------------------------------------- the kernel's schedule, mirrored
WARPS, ROWS, FLOOR = 4, 4, -1e30  # csrc/decode_attention.cu: kWarps, kRows, kFloor


def _heads(kvm, kh, ng):
    """Pass 1's warp-0 scan: the q heads h with kvm[h] == kh in rounds of up to ``ng``, found 32 at a
    time by ballots, each round resuming where the last one stopped."""
    h_all, rounds, cursor = len(kvm), [], 0
    while cursor < h_all:
        n, cur, heads = 0, cursor, []
        while cur < h_all and n < ng:
            bal = [cur + lane < h_all and int(kvm[cur + lane]) == kh for lane in range(32)]
            hits = [cur + lane for lane in range(32) if bal[lane]]
            heads += hits[:ng - n]
            if n + len(hits) > ng:
                cur = hits[ng - n]
                n = ng
            else:
                n += len(hits)
                cur += 32
        cursor = cur
        if n == 0:
            break
        rounds.append(heads)
    return rounds


def _two_passes(q, k, v, kvm, pos, scale, window, chunk):
    """The kernel's arithmetic in float32, block by block and warp by warp: partials of each chunk
    in range (warps joined in order), then the chunks joined in order."""
    b_all, _, h_all, _ = q.shape
    smax, k_all = k.shape[1], k.shape[2]
    ng = next(g for g in (1, 2, 4, 8) if g >= -(-h_all // k_all) or g == 8)
    lo, hi = (max(0, pos - window + 1) if window else 0), min(pos, smax - 1)
    nchunks = -(-smax // chunk)
    part = {}
    for b in range(b_all):
        for kh in range(k_all):
            for c in range(nchunks):
                r0, r1 = max(c * chunk, lo), min(c * chunk + chunk - 1, hi)
                if r0 > r1:
                    continue
                for heads in _heads(kvm, kh, ng):
                    for h in heads:
                        warps = []
                        for w in range(WARPS):
                            m, l, acc = torch.tensor(FLOOR), torch.tensor(0.0), torch.zeros(q.shape[3])
                            for rs in range(r0 + w * ROWS, r1 + 1, WARPS * ROWS):
                                rows = [r for r in range(rs, rs + ROWS) if r <= r1]
                                s = torch.stack([q[b, 0, h] @ k[b, r, kh] * scale for r in rows])
                                mx = torch.maximum(m, s.max())
                                alpha = torch.exp(m - mx)
                                m, l, acc = mx, l * alpha, acc * alpha
                                for r, sr in zip(rows, s):
                                    p = torch.exp(sr - m)
                                    l, acc = l + p, acc + p * v[b, r, kh]
                            warps.append((m, l, acc))
                        mx = max(m for m, _, _ in warps)
                        e = [torch.exp(m - mx) for m, _, _ in warps]
                        part[b, h, c] = (mx, sum(ei * l for ei, (_, l, _) in zip(e, warps)),
                                         sum(ei * a for ei, (_, _, a) in zip(e, warps)))
    out = torch.zeros_like(q)
    for b in range(b_all):
        for h in range(h_all):
            chunks = [part[b, h, c] for c in range(lo // chunk, hi // chunk + 1)]
            mx = max(m for m, _, _ in chunks)
            e = [torch.exp(m - mx) for m, _, _ in chunks]
            out[b, 0, h] = sum(ei * a for ei, (_, _, a) in zip(e, chunks)) / sum(ei * l for ei, (_, l, _) in
                                                                                  zip(e, chunks))
    return out


def test_head_rounds_resume_where_the_last_stopped():
    """40 q heads over 2 kv heads in blocks of 20: rounds of 8, 8 and 4, across the scan's 32-head
    window; a map that sends no head to a kv head gives it no round."""
    kvm = torch.arange(40) // 20
    assert _heads(kvm, 1, 8) == [list(range(20, 28)), list(range(28, 36)), list(range(36, 40))]
    assert _heads(torch.tensor([0, 2, 0, 2]), 1, 1) == []
    assert _heads(torch.tensor([1, 0, 1, 1, 0]), 1, 2) == [[0, 2], [3]]


@pytest.mark.parametrize("h,kh,pos,window", [
    (4, 4, 0, 0), (4, 4, 15, 0), (4, 4, 16, 0), (4, 4, 39, 0),  # chunk edges (chunk 16)
    (6, 2, 33, 5), (8, 3, 20, 0),                               # grouped; padded-style uneven groups
    (40, 2, 27, 0), (40, 2, 39, 20),                            # 20 q heads a kv head: three rounds
])
def test_kernel_schedule_is_the_plain_version(h, kh, pos, window):
    """The kernel's chunks, warps, rows in flight and joins, mirrored in float32 on the CPU, give
    the plain version in float32 up to the order of the sums."""
    g = torch.Generator().manual_seed(h + pos)
    q = torch.randn(2, 1, h, 8, generator=g)
    k, v = (torch.randn(2, 40, kh, 8, generator=g) for _ in range(2))
    kvm = layers.kv_head_map(h, kh, 6 if (h, kh) == (8, 3) else 0)
    want = decode_attention_ref(q, k, v, kvm, pos, scale=0.3, window=window)
    got = _two_passes(q, k, v, kvm, pos, 0.3, window, chunk=16)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------------ the seam
def _fits(cfg, p, *, device="cuda", dtype=torch.bfloat16, head_dim=D, pos=None):
    with FakeTensorMode():
        q = torch.empty(B, 1, cfg.num_heads, head_dim, dtype=dtype, device=device)
        k = torch.empty(B, SMAX, cfg.num_kv_heads, head_dim, dtype=dtype, device=device)
        at = torch.zeros((), dtype=torch.int32, device=device) if pos is None else pos
        return layers._decode_kernel_fits(cfg, p, q, k, k, at)


CALLS = {
    "fits": {},
    "int-pos": {"pos": 3},
    "cpu": {"device": "cpu"},
    "float32": {"dtype": torch.float32},
    "head-dim-12": {"head_dim": 12},
    "head-dim-264": {"head_dim": 264},
}


@pytest.mark.parametrize("mapping", sorted(MAPS))
@pytest.mark.parametrize("call", sorted(CALLS))
def test_kernel_path_is_chosen_by_what_the_call_observes(call, mapping):
    """On the card, bfloat16, a device ``pos``, D % 8 == 0 and D <= 256: the kernel, whatever
    the map; an int ``pos`` (dense, moe, vlm, encdec), the CPU, float32 or another head size:
    ``_attend_cache``."""
    cfg, p = _layer(mapping=mapping, dtype="bfloat16")
    assert _fits(cfg, p, **CALLS[call]) is (call == "fits")


@pytest.mark.parametrize("where", ["tp_group", "seq_split"])
def test_kernel_path_is_never_taken_when_sharded(where):
    """A ``tp_group`` (head-parallel decode) or a ``seq_split`` (a rank's shard of the sequence)
    keeps ``_attend_cache``, whose collectives join the ranks."""
    cfg, p = _layer(dtype="bfloat16")
    assert _fits(cfg, p)
    if where == "tp_group":
        p.tp_group = tp.Group(group=None, rank=0, size=1)
    else:
        p.seq_split = tp.SeqSplit(offset=0, groups=(), kvm=p.kvm)
    assert not _fits(cfg, p)


@pytest.fixture
def spy(monkeypatch):
    """Counts the calls of ``ops.decode_attention`` made through ``layers``."""
    calls = []
    real = ops.decode_attention

    def counting(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(layers.da_ops, "decode_attention", counting)
    return calls


@pytest.mark.parametrize("pos", [0, 7])
def test_attention_decode_on_the_cpu_takes_the_plain_path(spy, pos):
    """CPU tensors never reach the kernel's dispatcher, with ``pos`` as an int or a tensor."""
    cfg, p = _layer(dtype="bfloat16", window=3)
    x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    _, k, v = _qkv(cfg)
    outs = [layers.attention_decode(cfg, p, x, {"k": k.clone(), "v": v.clone()}, at)[0]
            for at in (pos, torch.tensor(pos, dtype=torch.int32))]
    assert spy == [] and torch.equal(*outs)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("family,mapping", [("zamba2", "identity"), ("hybrid", "identity"), ("dense", "grouped"),
                                            ("dense", "padded")])
def test_attention_decode_hands_the_kernel_the_layers_map_scale_and_window(spy, monkeypatch, family, mapping,
                                                                           window):
    """Where the call fits (here forced on the CPU, whose dispatcher runs the plain version),
    ``attention_decode`` passes the cache in place with the layer's ``kvm``, its family's
    scale and the window, and its output and the cache's new row are ``_attend_cache``'s path's
    bit for bit."""
    cfg, p = _layer(family=family, mapping=mapping, dtype="bfloat16", window=window)
    x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    _, k, v = _qkv(cfg)
    pos = torch.tensor(6, dtype=torch.int32)
    want, want_cache = layers.attention_decode(cfg, p, x, {"k": k.clone(), "v": v.clone()}, pos)
    assert spy == []
    monkeypatch.setattr(layers, "_decode_kernel_fits", lambda *a: True)
    got, got_cache = layers.attention_decode(cfg, p, x, {"k": k.clone(), "v": v.clone()}, pos)
    assert spy == [{"scale": layers.softmax_scale(cfg, D), "window": window}]
    assert torch.equal(got, want)
    assert all(torch.equal(got_cache[n], want_cache[n]) for n in ("k", "v"))


def test_kernel_wrapper_refuses_cpu_tensors_before_any_build():
    """The launcher checks devices before it looks for ``nvcc``: CPU tensors are a fault."""
    cfg, p = _layer(dtype="bfloat16")
    q, k, v = _qkv(cfg)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.decode_attention_cuda(q, k, v, p.kvm, torch.tensor(3, dtype=torch.int32), scale=0.25)


# ------------------------------------------------------- the benchmark's reader
@pytest.fixture
def roofline(monkeypatch):
    """``decode_attention_roofline.serve``'s reader over a hand-built trace of kernel times."""
    monkeypatch.syspath_prepend(str(ROOT))  # bench/ lives at the root
    from bench.harness import cell as cellmod
    from bench.harness.run_state import Run
    from bench.harness.spans import Spans
    from bench.harness.trace import Trace

    cell = cellmod.load("zamba2-7b-instruct.chat")
    read = cellmod.reader("decode_attention_roofline.serve")

    def of(kernel_s, profiled):
        trace = Trace(window_s=10.0, busy_s=9.0, kernel_s=kernel_s)
        return read(Run(spans=Spans(sync=False, device_type="cpu"), trace=trace, info={"profiled": profiled}), cell)

    return cell, of


def test_roofline_counts_each_steps_rows_up_to_pos(roofline):
    """13 sites x 32 rows x sum over the 63 steps of (1024 + t + 1) K/V rows of 2 x 32 x 224 bf16,
    with each step's q and output, at 3.35 TB/s, over the kernels' time (both passes)."""
    cell, read = roofline
    steps = cell.mix["new_tokens"] - 1
    rows = sum(1024 + t + 1 for t in range(steps))
    nbytes = 13 * 32 * (rows * 2 * 32 * 224 * 2 + steps * 32 * 224 * 2 * 2)
    least = nbytes / 3.35e12
    times = {"void (anonymous namespace)::decode_attention_chunk<1>(...)": 0.75 * least,
             "void (anonymous namespace)::decode_attention_merge(...)": 0.25 * least, "elementwise_kernel": 5.0}
    assert read(times, {"batch": 32, "seq_len": 1024}) == pytest.approx(100.0)
    assert read(times, {"batch": 16, "seq_len": 1024}) == pytest.approx(50.0)


@pytest.mark.parametrize("kernel_s,profiled", [
    ({"elementwise_kernel": 1.0, "index_elementwise_kernel": 2.0}, {"batch": 32, "seq_len": 1024}),  # plain path
    ({"decode_attention_merge": 1.0}, None),                                                          # not profiled
], ids=["no-kernel", "no-profiled-batch"])
def test_roofline_without_the_kernel_gives_nothing(roofline, kernel_s, profiled):
    _, read = roofline
    assert read(kernel_s, profiled) is None
