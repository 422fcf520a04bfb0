"""Dense graph ops and the attention kernels (`ops/kernels`)."""
