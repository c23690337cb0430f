"""``step_idle_ms_per_request.eval``'s reading, for the serving cell, whose rate is an
end-to-end metric of its own."""

from pathlib import Path

from portbench.harness import load_file_module

read = load_file_module(Path(__file__).with_name("step_idle_ms_per_request.eval.py"),
                        "portbench_metric_step_idle_ms_per_request").read
