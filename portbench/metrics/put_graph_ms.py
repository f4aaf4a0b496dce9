"""The driver's put of the graph and its plans, the program's ``put_graph`` record, ms a call."""

from portbench import layers


def read(ctx):
    return layers.put_graph_ms(ctx)
