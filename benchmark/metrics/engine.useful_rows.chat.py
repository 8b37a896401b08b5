"""Rows that carried a token over rows computed (%), over the engine's
decode, mixed and prefill steps that started in the window."""
from benchmark.program_spans import useful_rows as read  # noqa: F401
