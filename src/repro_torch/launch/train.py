"""Training launcher: `python -m repro_torch.launch.train --arch <id> [...]`.

The reference's flow: the mesh (``--mesh host`` is this process group's, one
card a (1, 1) mesh) -> ``pad_config_for_mesh`` -> ``make_train_fn`` -> AdamW
-> ``host_batch`` -> ``CheckpointManager`` every ``--ckpt-every`` steps ->
``--resume``.  Reduced configs by default, ``--full`` for the registry's.
Runs on the card unless ``--device cpu`` is given.

Differences from the reference's launcher, which cannot import (it imports
``StragglerPolicy`` from ``repro.elastic.remap``, where nothing defines it):

- no straggler policy: nothing in the reference defines one to port;
- a checkpoint is saved after every ``--ckpt-every`` steps and keyed by the
  number of steps taken, so ``--resume`` starts at the first step not yet
  taken (the reference keys it by the index of the step just taken and
  resumes at that index, taking that step twice); each save prints a line;
- ``--metrics-json PATH`` writes one JSON object a step (loss, lr, grad
  norm, host ms around the synchronised step, and each kernel's launches and
  plain backwards in it, from the counters of ``kernels/*/ops.py``).
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, host_batch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import _device
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.train.step import make_train_fn


def _counts() -> dict[str, list[int]]:
    return {"ssd_scan": [ssd_ops.LAUNCHES, ssd_ops.BACKWARDS], "flash_attention": [fa_ops.LAUNCHES, fa_ops.BACKWARDS]}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced config (the default); --full takes the registry's")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mesh", choices=["host", "production", "multipod"], default="host")
    ap.add_argument("--layout", choices=list(rules.LAYOUTS), default="baseline")
    ap.add_argument("--grad-dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--metrics-json", default=None, help="write one JSON line a step here")
    args = ap.parse_args(argv)

    dev = _device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    try:
        if args.mesh == "host":
            mesh = make_host_mesh(device=dev)
        else:
            mesh = make_production_mesh(multi_pod=(args.mesh == "multipod"), device=dev)
    except RuntimeError as err:
        raise SystemExit(f"--mesh {args.mesh}: {err}") from err
    cfg = rules.pad_config_for_mesh(cfg, mesh, args.layout)

    model = get_model(cfg)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5), total_steps=args.steps)
    step_fn = make_train_fn(cfg, ocfg, grad_dtype=args.grad_dtype)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw.init(params)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, consolidate_every=4) if args.ckpt_dir else None

    start = 0
    if args.resume and mgr is not None:
        restored, start = mgr.restore({"params": dict(params.named_parameters()), "opt": opt})
        params.load_state_dict(restored["params"])
        opt = restored["opt"]
        print(f"resumed at step {start}")

    n = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n/1e6:.1f}M mesh={rules.mesh_axes(mesh)} layout={args.layout}")
    log = open(args.metrics_json, "w") if args.metrics_json else None
    try:
        for step in range(start, args.steps):
            before = _counts()
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch(cfg, dcfg, step).items()}
            params, opt, metrics = step_fn(params, opt, batch)
            values = {k: float(v) for k, v in metrics.items()}  # waits for the step
            ms = (time.time() - t0) * 1e3
            if log is not None:
                after = _counts()
                counts = {k: [a - b for a, b in zip(after[k], before[k])] for k in after}
                log.write(json.dumps({"step": step, **values, "ms": ms, **counts}) + "\n")
                log.flush()
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss={values['loss']:.4f} lr={values['lr']:.2e} {ms:.0f}ms", flush=True)
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": dict(params.named_parameters()), "opt": opt})
                print(f"checkpointed @{step + 1}", flush=True)
    finally:
        if log is not None:
            log.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    print("done")


if __name__ == "__main__":
    main()
