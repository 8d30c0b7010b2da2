"""Readings that the limits of ``correct`` are set from, at a cell's own
size and load: for each seed, a short window of the program (one pass over
the clip pool by default) and the check with the control (the reference in
the precision below the configuration's) beside it.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--clips 8]

Prints one JSON line per seed: each compared number's worst reading over
the sampled outputs (``value``), the control's least reading
(``control``) and the configuration's limit.  The benchmark's own runs do
not run the control.

    python3 portbench/calibrate.py --workload crop-icip-mesh4 \
        --seeds 1,2,3 --control-only [--every-clip]

reads the control alone, clip by clip, on one card, for a path that offers
``control_readings`` (``crop_mesh``: the control needs none of the ranks):
on the clips a run with the seed checks, or on every clip of the batch.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == '__main__':
    from portbench import core
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--clips', type=int, default=8)
    ap.add_argument('--control-only', action='store_true')
    ap.add_argument('--every-clip', action='store_true')
    args = ap.parse_args()
    if args.control_only:
        import torch
        _, _, cfg, traffic = core.load_cell(args.workload)
        path = core.load_module('paths', traffic['path'])
        for seed in (int(s) for s in args.seeds.split(',')):
            clips = path.control_readings(cfg, traffic, seed,
                                          torch.device('cuda', 0),
                                          every=args.every_clip)
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'control': clips}), flush=True)
        sys.exit(0)
    for seed in (int(s) for s in args.seeds.split(',')):
        res = core.run(args.workload, seed, 0.0, False,
                       t_process=time.perf_counter(), control=True,
                       clips=args.clips)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'correct': res['correct'],
                          'checks': res['checks'],
                          'readings': res['readings']}), flush=True)
