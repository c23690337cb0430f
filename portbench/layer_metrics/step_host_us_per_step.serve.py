"""``step_host_us_per_step.eval``'s reading, for the serving cell, whose rate is an
end-to-end metric of its own."""

from pathlib import Path

from portbench.harness import load_file_module

read = load_file_module(Path(__file__).with_name("step_host_us_per_step.eval.py"),
                        "portbench_metric_step_host_us_per_step").read
