"""swin_block.roofline_pct (%, Swin block layer): the least time of every
Swin transformer block call of the traced window (qkv, the window
attention's two products, proj, fc1, fc2 at the block's token count;
activations in and out and the block's weights read once) over the device
time launched inside those calls."""

from portbench import costs

MODULE = "models.swinir.SwinBlock"


def cost(call, run):
    qname, shape, _ = call
    b, h, w, c = shape
    hidden = run.shapes[f"{qname}.mlp.fc1.weight"][0]
    ws = run.cell.config["arch"]["window_size"]
    flop = costs.swin_block_flop(b * h * w, c, hidden, ws)
    return flop, costs.activation_bytes(shape, shape) + \
        costs.params_bytes(run, qname)


def read(run):
    return costs.roofline_pct(run, MODULE, cost)
