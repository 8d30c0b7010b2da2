"""``mfu``: the least time for a clip's model FLOPs (each model's conv and
dense FLOPs at the clip's live sizes over the card's published peak in the
precision its convolutions run in) over the traced window's seconds per
clip, %."""

from portbench.counts.flops import PEAK_FLOPS


def read(rec):
    if not rec.get('model_flops') or not rec['clips']:
        return None
    least = sum(f / PEAK_FLOPS[dtype] for f, dtype in rec['model_flops'])
    return 100.0 * least / (rec['window_s'] / rec['clips'])
