"""restormer_block.roofline_pct (%, Restormer block layer): the least time
of every Restormer transformer block call of the traced window (MDTA and
GDFN products and depthwise taps at the block's pixel count; activations
in and out and the block's weights read once) over the device time
launched inside those calls, whichever route the block took."""

from portbench import costs

MODULE = "models.restormer.TransformerBlock"


def cost(call, run):
    qname, shape, _ = call
    b, h, w, c = shape
    heads = run.shapes[f"{qname}.attn.temperature"][0]
    hidden = run.shapes[f"{qname}.ffn.project_out.weight"][1]
    flop = costs.restormer_block_flop(b * h * w, c, heads, hidden)
    return flop, costs.activation_bytes(shape, shape) + \
        costs.params_bytes(run, qname)


def read(run):
    return costs.roofline_pct(run, MODULE, cost)
