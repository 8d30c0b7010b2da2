"""Host utilities: the stage timing registry and debug plots."""
