from repro_torch.roofline.analysis import H100_SXM, HW, roofline_terms  # noqa: F401
