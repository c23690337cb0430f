"""Door-task data collection (port of ``scripts/door_task/data_collection``)."""
