"""The repo's examples on the port (counterparts of ``examples/``)."""
