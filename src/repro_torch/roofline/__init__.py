"""Counts of a program against the H100's peaks (``counts``), and the
reports built from the dry run's JSON (``report``, ``fill_experiments``)."""
