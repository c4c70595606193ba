"""The yardstick: the table of peaks and the work counted from the problem."""
