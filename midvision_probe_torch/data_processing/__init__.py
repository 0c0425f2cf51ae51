"""The port's data tools (counterparts of the repository's
``data_processing/``): instance-mask extraction over MaskCut
(``extract_instance_masks``), the weights-landing drill
(``convert_checkpoints --all``) with its goldens (``export_golden``) and
their independent torch replicas (``torch_replicas``). Each runs as
``python -m midvision_probe_torch.data_processing.<name>``."""
