"""Host utilities: the stage timing registry, debug plots and the temporal
smoother."""
