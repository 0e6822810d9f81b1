from repro_torch.analysis.hlo import HloAnalysis, analyze  # noqa: F401
