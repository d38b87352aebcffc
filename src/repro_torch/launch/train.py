"""Training launcher of the port, as ``repro.launch.train``: the
fault-tolerant loop (``train.loop.train``) on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --steps 50 --device cpu

``--full`` trains the published configuration instead of its
``reduced()`` smoke one; the default device is the CUDA card.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import get_arch, list_archs
from repro_torch.train.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="full (not reduced) architecture config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu: plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tcfg = TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq_len,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       peak_lr=args.peak_lr, microbatch=args.microbatch,
                       device=args.device)
    res = train(cfg, tcfg)
    print(f"arch={args.arch} steps={res.final_step} restarts={res.restarts} "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    return res


if __name__ == "__main__":
    main()
