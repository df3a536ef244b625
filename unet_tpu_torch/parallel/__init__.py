"""Parallel training over ranks on `torch.distributed` (port of
unet_tpu/parallel): `distributed` (rendezvous, subgroups, rows of the
global batch, checkpoint gathers, the one-command launcher), `mesh` (the
data x model mesh and the DP, FSDP, TP, tp x fsdp and spatial train step
over the flat state), `tensor` (Megatron tensor parallelism's collectives
and splits) and `spatial` (spatial sharding's halo, statistics and row
gathers)."""
