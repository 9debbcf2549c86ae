"""waves_per_tree: the wave grower's waves a tree (``GBDT.wave_stats``),
the mean over the window's trees; nothing where the trees came from
another grower."""


def read(run):
    waves = [w for w, _ in run.window_wave_stats if w >= 0]
    if not waves:
        return None
    return sum(waves) / len(waves)
