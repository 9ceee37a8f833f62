"""conv3x3.roofline_pct (%, conv layer): the least time of every 3x3 conv
module call of the traced window (the products at the input's pixel
count; the input, a residual where one is added, the output and the
weights read once) over the device time launched inside those calls."""

from portbench import costs

MODULE = "models.common.Conv"


def cost(call, run):
    qname, shape, kw = call
    cout, cin = run.shapes[f"{qname}.weight"][:2]
    b, h, w, _ = shape
    pixels = b * h * w
    extra = [kw["res"]] if "res" in kw else []
    nbytes = costs.activation_bytes(shape, (pixels, cout), *extra) + \
        costs.params_bytes(run, qname)
    return costs.conv3x3_flop(pixels, cin, cout), nbytes


def read(run):
    return costs.roofline_pct(run, MODULE, cost)
