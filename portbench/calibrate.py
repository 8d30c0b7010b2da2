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
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(',')):
        res = core.run(args.workload, seed, 0.0, False,
                       t_process=time.perf_counter(), control=True,
                       clips=args.clips)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'correct': res['correct'],
                          'checks': res['checks'],
                          'readings': res['readings']}), flush=True)
