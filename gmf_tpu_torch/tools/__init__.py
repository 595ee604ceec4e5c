"""Command-line tools of the port: ``bench_flash_variants`` times the
compat attention's forward variants on the card; ``precompute_descriptors``
and ``build_kitti_pairs`` write the descriptor npz files the loaders read
(FPFH or FCGF on the card); ``analyze_stats`` summarises saved evaluation
statistics; ``numerics_study`` compares power iteration with ``eigh`` and
the Horn-quaternion Kabsch with the SVD one; ``print_checkpoint`` and the
``compare_*_builds`` tools."""
