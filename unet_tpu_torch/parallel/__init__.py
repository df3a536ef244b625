"""Data-parallel training over ranks on `torch.distributed` (port of the
data axis of unet_tpu/parallel): `distributed` (rendezvous, rows of the
global batch, checkpoint gathers, the one-command launcher) and `mesh` (the
DP and FSDP train step over the flat state)."""
