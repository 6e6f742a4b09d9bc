"""Quickstart on the PyTorch port: the paper's technique in five minutes.

The port's counterpart of ``examples/quickstart.py``:

1. builds a reduced qwen3-style model with the HDM tier map (params in
   the POOL tier = the CXL DRAM-EP analogue),
2. runs a few training steps under the speculative-read layer stream with
   deterministic-store gradients,
3. decodes a few tokens through the paged cache (on the card, the
   ``paged_decode`` kernel),
4. runs the paper's own evaluation simulator for one workload.

  python examples/quickstart_torch.py                 # on the card
  python examples/quickstart_torch.py --device cpu
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def quickstart(params=None, *, cfg=None, tokens=None, device="cuda",
               n_steps: int = 5, n_ops: int = 5000, log=print) -> dict:
    """The example's work: ``n_steps`` training steps of smoke qwen3-1.7b
    (``cfg``; ``params`` random from seed 0 unless given, e.g. the
    reference's carried by ``bridge.params_from_jax``) on ``tokens`` [4,
    64] (drawn from seed 1 unless given), three greedy decode steps of two
    rows from the trained weights, and the simulator's slowdowns. Returns
    the losses, the decoded tokens and the simulator's ratios."""
    cfg = cfg or registry.smoke("qwen3-1.7b")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=4,
                                seq_len=64)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig(),
                   sr_prefetch_depth=1, ds_enabled=True)
    dev = torch.device(device)
    if params is None:
        params = M.init_model(cfg, device=dev)
    opt_cfg = adamw.AdamWConfig(learning_rate=1e-2, warmup_steps=0)
    state = steps_lib.init_state(params, rc, opt_cfg)
    step = steps_lib.build_train_step(cfg, rc, opt_cfg)
    if tokens is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                               device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    out = {"losses": [], "decoded": []}
    for i in range(n_steps):
        state, metrics = step(state, batch)
        out["losses"].append(float(metrics["loss"]))
        log(f"train step {i}: loss={out['losses'][-1]:.4f}")

    # --- decode through the paged cache ----------------------------------
    model = state.params.requires_grad_(False)
    cache = M.cache_init(cfg, rc, 2, max_seq=32, device=dev)
    tok = torch.tensor([[1], [2]], dtype=torch.int32, device=dev)
    for i in range(3):
        logits, cache = M.decode_step(model, cfg, rc, tok, cache)
        tok = logits.argmax(-1).to(torch.int32)
        out["decoded"].append(tok.reshape(-1).tolist())
        log(f"decode step {i}: tokens={out['decoded'][-1]}")

    # --- the paper's simulator -------------------------------------------
    from repro_torch.sim import run
    base = run("gpu-dram", "vadd", "dram", n_ops=n_ops).exec_ns
    out["sim"] = {}
    for config in ("uvm", "cxl"):
        r = run(config, "vadd", "dram", n_ops=n_ops)
        out["sim"][config] = r.exec_ns / base
        log(f"sim {config:4s}: {out['sim'][config]:6.1f}x ideal")
    c = run("cxl", "vadd", "znand", n_ops=n_ops)
    s = run("cxl-sr", "vadd", "znand", n_ops=n_ops)
    out["sim"]["cxl-sr over cxl"] = c.exec_ns / s.exec_ns
    log(f"sim cxl-sr over cxl on Z-NAND: {c.exec_ns / s.exec_ns:.2f}x")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    quickstart(device=args.device)


if __name__ == "__main__":
    main()
