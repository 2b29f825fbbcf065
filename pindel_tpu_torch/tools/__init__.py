"""The port's measurement tools (``python -m pindel_tpu_torch.tools.X``)
and what they share (``measure``)."""
