"""CLI drivers mirroring the reference's examples/demo_*.cpp binaries."""
