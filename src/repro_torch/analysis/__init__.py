"""Run reports from telemetry JSONL files (:mod:`repro_torch.analysis.report`)."""
