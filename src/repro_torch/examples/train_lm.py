"""End-to-end training example: data pipeline -> train step -> LSM incremental
checkpointing -> crash recovery.

Presets:
    smoke (default): ~8M-param qwen2.5-family model, 120 steps.
    100m:            ~100M-param config, a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 120 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300

Runs on the card unless ``--device cpu`` is given.  The reference's example
also keeps a straggler policy, which nothing in the reference defines
(``StragglerPolicy``); the port has none.  A checkpoint is keyed by the
number of steps taken, so ``--resume`` starts at the first step not yet taken.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.models import get_model
from repro_torch.models.layers import _device
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_fn


def make_config(preset: str):
    base = ARCHS["qwen2.5-3b"]
    if preset == "smoke":
        return dataclasses.replace(
            base.reduced(), name="qwen2.5-smoke", num_layers=4, d_model=128,
            num_heads=4, num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
        )
    # ~100M: 12L x 512d x 2048ff, 32k vocab
    return dataclasses.replace(
        base, name="qwen2.5-100m", num_layers=12, d_model=512, num_heads=8,
        num_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32768,
        param_dtype="float32", compute_dtype="float32", remat=False,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro-train-lm"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    dev = _device(args.device)
    cfg = make_config(args.preset)
    model = get_model(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_fn(cfg, ocfg)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, consolidate_every=4)

    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw.init(params)
    nparams = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={nparams/1e6:.1f}M steps={args.steps}")

    start = 0
    if args.resume:
        restored, start = mgr.restore({"params": dict(params.named_parameters()), "opt": opt})
        params.load_state_dict(restored["params"])
        opt = restored["opt"]
        print(f"resumed from checkpoint at step {start}")

    t_start = time.time()
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch(cfg, dcfg, step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"{(time.time()-t0)*1e3:.0f}ms")
        if (step + 1) % args.ckpt_every == 0:
            stats = mgr.save(step + 1, {"params": dict(params.named_parameters()), "opt": opt})
            print(f"  checkpointed @{step + 1}: {stats} "
                  f"write_amp={mgr.stats()['write_amplification']:.2f}")
    tok_s = (args.steps - start) * args.batch * args.seq / (time.time() - t_start)
    print(f"done: {tok_s:.0f} tokens/s")


if __name__ == "__main__":
    main()
