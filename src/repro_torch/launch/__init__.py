"""Launchers: model building and train steps (``steps``), the serving loop
(``serve``) and the training loop (``train``)."""
