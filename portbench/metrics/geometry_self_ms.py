"""``geometry_self_ms``: the median over the traced window's clips of the
program's ``geometry`` stage less its five child spans in the same clip
(threshold, border, centres, fill and boxes: what no child times), ms."""

import statistics

CHILDREN = ('geometry.cluster', 'geometry.redo', 'geometry.interpolate',
            'geometry.lowpass', 'geometry.loess')


def read(rec):
    geometry = rec['stages'].get('geometry')
    children = [rec['stages'].get(name) for name in CHILDREN]
    if not geometry or any(c is None or len(c) != len(geometry)
                           for c in children):
        return None
    return statistics.median(g - sum(parts)
                             for g, *parts in zip(geometry, *children))
