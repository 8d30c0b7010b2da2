"""``postprocess_roofline``: the least time the saliency postprocess
needs at the clip's live sizes (its float32 log-probabilities read once and
uint8 maps written once at the card's HBM bandwidth) over the device time
of the kernels named ``saliency_postprocess_kernel*`` per profiled clip, %.
"""

from portbench.counts.bytes import HBM_BYTES_PER_S


def read(rec):
    p = rec.get('profile')
    if not p or not rec.get('postprocess_bytes'):
        return None
    secs = sum(t for name, (t, _) in p['kernels'].items()
               if 'saliency_postprocess_kernel' in name)
    if secs <= 0:
        return None
    least = rec['postprocess_bytes'] / HBM_BYTES_PER_S
    return 100.0 * least / (secs / p['clips'])
