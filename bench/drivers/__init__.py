"""Drivers, one per kind of traffic, named by a traffic file's
``driver``: each runs one cell once and returns the records its metrics
read (:func:`run`)."""
