"""Command-line tools of the port: ``bench_flash_variants`` times the
compat attention's forward variants on the card."""
