"""One file a kind of traffic (``kind`` in a traffic file): how a run
of that kind drives the port and times its window, and how the control
of that kind is read.  The harness finds the file by the kind's name."""
