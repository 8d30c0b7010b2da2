"""``tnv2_similarity_ms``: the median over the traced window's clips of
the program's span ``transnet.similarity`` (TransNet V2's frame-similarity
and colour-histogram branches: projection, histograms, the T x T products
and the 101-wide bands; CUDA events), ms."""

import statistics


def read(rec):
    times = rec['stages'].get('transnet.similarity')
    return statistics.median(times) if times else None
