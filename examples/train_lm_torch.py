"""End-to-end training example on the PyTorch port: a ~100M-class
model, a few hundred steps, with checkpoint/restart.

The port's counterpart of ``examples/train_lm.py``.

  python examples/train_lm_torch.py --steps 200            # on the card
  python examples/train_lm_torch.py --steps 30 --device cpu
  python examples/train_lm_torch.py --steps 10 --resume    # 10 more
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import train  # noqa: E402


def train_lm(arch: str = "xlstm-125m", *, steps: int = 200,
             ckpt: str = "artifacts/train_lm_torch", resume: bool = False,
             device="cuda", global_batch: int = 8, seq_len: int = 128,
             log_every: int = 10) -> dict:
    """The example's work: ``train`` on ``arch``'s smoke config for
    ``steps`` steps (with ``resume``, ``steps`` more from the last
    checkpoint in ``ckpt``), checkpointing into ``ckpt``. Returns
    ``train``'s result, its loss history included."""
    # xlstm-125m's smoke config is a ~100M-class recurrent LM at full
    # width scale-down; swap arch for any of the configs
    return train(arch, smoke=True, steps=steps, ckpt_dir=ckpt,
                 global_batch=global_batch, seq_len=seq_len,
                 log_every=log_every, resume=resume, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--ckpt", default="artifacts/train_lm_torch")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train_lm(args.arch, steps=args.steps, ckpt=args.ckpt,
                   resume=args.resume, device=args.device)
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"(checkpoints in {args.ckpt})")
    if not args.resume:
        assert last < first, "loss should decrease"


if __name__ == "__main__":
    main()
