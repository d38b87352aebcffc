"""Train an embedding-tower LM (reduced config) with the port's
fault-tolerant loop: checkpoints, a simulated mid-run failure, and resume.
The counterpart of ``examples/train_embedder.py``.

    PYTHONPATH=src python examples/torch_train_embedder.py [--arch qwen2-7b] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from repro_torch.configs.base import get_arch
from repro_torch.train.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_example"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu: plain versions)")
    args = ap.parse_args(argv)

    shutil.rmtree(args.ckpt, ignore_errors=True)
    cfg = get_arch(args.arch).reduced()
    tcfg = TrainConfig(steps=args.steps, batch=8, seq_len=128, ckpt_dir=args.ckpt,
                       ckpt_every=10, peak_lr=1e-3, device=args.device)

    tripped = {"done": False}

    def chaos(step):  # one injected node failure mid-run
        if step == args.steps // 2 and not tripped["done"]:
            tripped["done"] = True
            print(f"!! injecting node failure at step {step} "
                  f"(loop will restore the latest checkpoint)")
            return True
        return False

    res = train(cfg, tcfg, fail_injector=chaos)
    print(f"arch={args.arch} (reduced) steps={res.final_step} restarts={res.restarts}")
    print(f"loss: first={res.losses[0]:.3f} last={res.losses[-1]:.3f}")
    if not res.losses[-1] < res.losses[0]:
        raise SystemExit("loss did not decrease")
    print("ok: trained through a failure with checkpoint/restore")
    return res


if __name__ == "__main__":
    main()
