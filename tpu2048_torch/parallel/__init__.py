"""Data-parallel training over ranks: the layout, the collectives and the
test rig."""
