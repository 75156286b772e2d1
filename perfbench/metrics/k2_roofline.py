"""k2_roofline (kernels): percent of its roofline that K2 reached
in the stretch (roofline/k2.py counts its work)."""
from perfbench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k2")
