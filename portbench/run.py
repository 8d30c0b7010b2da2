"""Run one cell of the benchmark once, on the GPU of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Prints the result as one JSON line, the
last line of standard output; without a usable GPU, or when JAX or the JAX
package is loaded once the window has closed, it prints no result and
exits non-zero.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache inside the checkout, at fixed paths.
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('CUDA_CACHE_PATH', 'nv_compute_cache')):
    os.environ[var] = os.path.join(ROOT, 'build', 'portbench', sub)
os.environ.setdefault('OMP_NUM_THREADS', '2')
sys.path.insert(0, ROOT)

if __name__ == '__main__':
    from portbench import core
    sys.exit(core.main(sys.argv[1:], T_PROCESS))
