"""One file a model family: the layout of its weights as the port lays
them out, its batches, and its matmul count.  A configuration file names
its family under ``init``; the generator finds the file by that name."""
