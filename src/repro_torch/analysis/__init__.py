"""Analysis of runs: reports from telemetry JSONL files
(:mod:`repro_torch.analysis.report`), the dry run's op counter
(:mod:`repro_torch.analysis.ops`) and its roofline on one H100
(:mod:`repro_torch.analysis.roofline`)."""
