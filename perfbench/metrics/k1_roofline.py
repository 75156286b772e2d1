"""k1_roofline (kernels): percent of its roofline that K1 reached
in the stretch (roofline/k1.py counts its work)."""
from perfbench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k1")
