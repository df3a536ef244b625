"""Parallel training over ranks on `torch.distributed` (port of
unet_tpu/parallel): `distributed` (rendezvous, subgroups, rows of the
global batch, checkpoint gathers, the one-command launcher), `mesh` (the
data x model mesh and the DP, FSDP, TP and tp x fsdp train step over the
flat state) and `tensor` (Megatron tensor parallelism's collectives and
splits)."""
