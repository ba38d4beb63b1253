"""Content forms, one module each, named by a mix's ``content`` key:
``make(cfg, mix, rng, frames)`` draws a ``gen.Clip`` of ``frames``
frames at the configuration's size from the mix's parameters."""
