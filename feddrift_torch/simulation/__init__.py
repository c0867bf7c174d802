"""The experiment runner (``runner.Experiment``)."""
