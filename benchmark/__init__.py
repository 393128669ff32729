"""The benchmark of echo_tts_torch (see BENCHMARK.json and PERF.md)."""
