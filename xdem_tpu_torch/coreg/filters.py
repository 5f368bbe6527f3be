"""Coregistration filters: a placeholder, as in xdem_tpu and the xdem it follows.

Outliers are handled by inlier masks and by the robust estimators inside each method.
"""
