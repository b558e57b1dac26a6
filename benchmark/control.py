"""Readings that the check's limits are set from, on the card at the cell's
own size, one JSON line per reading:

* ``program``: the program's first training steps against the float64
  reference, on each seed (the lower readings);
* ``control``: the reference in the precision below the configuration's
  (float32 with TF32 products) in the program's place (an upper reading);
* ``half_batch``, ``altered``: the reference with a fault planted (half of
  the batch left out, the mean taken over the rest; the first leaf's
  gradient 10 % off) in the program's place;
* ``sampler``: for the SDE cell, the largest gap between the program's
  first sampled batch and the reference's, by part (the stage the loss
  check reads through).

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \
        [--what program control half_batch altered sampler]

The benchmark's own runs do not run it.  A state left unchanged reads 1 by
``change_gap`` and needs no run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--what", nargs="+",
                        default=["program", "control", "half_batch", "altered"])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import gc

    import torch

    from benchmark import check, harness

    cell = harness.find_cell(args.workload)
    reference = cell.module("reference")
    n_check = cell.workload["check_steps"]
    for seed in args.seeds:
        cfg, trainer, params0, rec, _ = harness.build(cell, seed, "cuda")
        sampled = {}
        if "sampler" in args.what:
            sample = trainer.method.sample_data

            def keep_first(key, *a, **kw):
                out = sample(key, *a, **kw)
                if not sampled:
                    sampled.update({k: v.detach().clone() for k, v in out.items()})
                return out

            trainer.method.sample_data = keep_first
        t0 = time.perf_counter()
        program = harness.check_steps(cfg, trainer, rec, params0, n_check)
        t_prog = time.perf_counter() - t0
        del trainer, rec
        gc.collect()
        torch.cuda.empty_cache()
        ref_cfg = {"settings": {**cell.settings, "seed": seed}, "problem": cell.config["problem"]}
        t0 = time.perf_counter()
        ref = reference.follow_cell(ref_cfg, seed, params0, "cuda", n_steps=n_check)
        t_ref = time.perf_counter() - t0
        rows = {}
        if "program" in args.what:
            rows["program"] = check.gaps(program, ref)
        if "control" in args.what:
            rows["control"] = check.gaps(reference.follow_cell(
                ref_cfg, seed, params0, "cuda", dtype=torch.float32, tf32=True, n_steps=n_check), ref)
        for fault in ("half_batch", "altered"):
            if fault in args.what:
                rows[fault] = check.gaps(reference.follow_cell(
                    ref_cfg, seed, params0, "cuda", fault=fault, n_steps=n_check), ref)
        if sampled:
            prob = reference.Problem(ref_cfg, "cuda", torch.float64)
            key_trainer = harness.ref_common.split(seed, 4)[2]
            train_key = harness.ref_common.split(key_trainer, 2)[0]
            key_sample = harness.ref_common.split(harness.ref_common.fold_in(train_key, 0), 2)[0]
            mine = prob.sample(key_sample)
            rows["sampler"] = {k: float((sampled[k].double() - mine[k]).abs().max()) for k in mine}
        losses = {"program_losses": program.losses, "reference_losses": ref.losses,
                  "reference_loss_scales": ref.loss_scales}
        for what, gaps in rows.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what, **gaps,
                              **(losses if what == "program" else {}),
                              "program_s": t_prog, "reference_s": t_ref,
                              "kind": torch.cuda.get_device_name()}), flush=True)
        del params0
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
