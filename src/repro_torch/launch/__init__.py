"""Launchers: model building (``steps``) and the serving loop (``serve``)."""
