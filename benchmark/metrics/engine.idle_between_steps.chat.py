"""Share of the window (%) in which the stream waited between one engine
step's end event and the next step's start event (all steps in it)."""
from benchmark.program_spans import idle_between_steps as read  # noqa: F401
