#!/usr/bin/env python3
"""Time an earlier version of the saliency-postprocess kernel in turns with
the current one, on one NVIDIA GPU.

    mkdir -p build
    git show f58955f:retargetvid_tpu_torch/csrc/saliency_postprocess.cu \\
        > build/earlier_saliency_postprocess.cu
    python3 kernel_turns.py build/earlier_saliency_postprocess.cu

The earlier source exports ``rtv_saliency_postprocess(logp, out, t, hw,
stream)`` (the one-block-per-frame design of commit f58955f) and is built
with the port's ``nvcc`` flags.  Both kernels are held bit-equal to the
plain version at the main path's shape (96, 140, 250); then each is timed
as ``chip_smoke.py`` times a kernel (``device_ms``: a CUDA graph of 60
launches replayed between two events, cold and warm) in turns -- earlier,
current, current, earlier -- on the same inputs.  Prints one JSON line with
the card's name and power limit; exits non-zero if anything fails.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

from chip_smoke import MAIN_SHAPE, card_line, device_ms, emit, fail, log_maps


def earlier_kernel(source: Path):
    """Build ``source`` and return a wrapper that launches it."""
    import torch

    from retargetvid_tpu_torch.kernels.build import BUILD_DIR, nvcc_command
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / 'earlier_saliency_postprocess.so'
    proc = subprocess.run(nvcc_command(source, target), capture_output=True,
                          text=True)
    if proc.returncode:
        fail(f'nvcc failed for {source}:\n{proc.stdout}{proc.stderr}')
    fn = ctypes.CDLL(str(target)).rtv_saliency_postprocess
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(x):
        out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
        rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0],
                x.shape[1] * x.shape[2],
                torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f'the earlier kernel did not launch: CUDA error {rc}')
        return out
    return launch


def main():
    if len(sys.argv) != 2:
        fail('usage: python3 kernel_turns.py EARLIER.cu')
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this needs a CUDA GPU')

    from retargetvid_tpu_torch.kernels.postprocess import (
        saliency_postprocess,
        saliency_postprocess_reference,
    )
    source = Path(sys.argv[1]).resolve()
    kernels = {'earlier': earlier_kernel(source),
               'current': saliency_postprocess}
    logp, _ = log_maps(MAIN_SHAPE, seed=0)
    cold = [logp] + [log_maps(MAIN_SHAPE, seed=10 + i)[0] for i in range(5)]
    ref = saliency_postprocess_reference(logp)
    n_diff = {k: int((f(logp) != ref).sum()) for k, f in kernels.items()}
    if any(n_diff.values()):
        fail(f'pixels differing from the plain version: {n_diff}')
    turns = [{'kernel': k, 'ms_device': device_ms(kernels[k], cold),
              'ms_device_warm': device_ms(kernels[k], [logp])}
             for k in ('earlier', 'current', 'current', 'earlier')]
    emit(card_line(), phase='kernel_turns', source=str(source),
         shape=list(MAIN_SHAPE), n_diff=n_diff, turns=turns)


if __name__ == '__main__':
    main()
