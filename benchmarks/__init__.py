"""The benchmark of metadrive_ped_torch (see README.md)."""
