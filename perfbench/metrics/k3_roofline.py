"""k3_roofline (kernels): percent of its roofline that K3 reached
in the stretch (roofline/k3.py counts its work)."""
from perfbench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "k3")
