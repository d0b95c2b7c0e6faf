"""The H100 roofline model of the port (`analysis`)."""
