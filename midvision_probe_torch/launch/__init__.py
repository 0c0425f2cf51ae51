"""The port's launchers (counterparts of the repository's ``launch_script/``):
the backbone sweep (``sweep``), the full-suite runner (``suite_run``) and
the ranking tables over the suite's CSVs (``aggregate_results``). Each runs
as ``python -m midvision_probe_torch.launch.<name>``; the cells are the
port's drivers, one process each, on the card unless ``--device cpu``."""
