"""Launchers: the serve and train drivers, the device meshes, and the
production-mesh dry run."""
