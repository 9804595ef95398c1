"""OpenCV's polygon drawing in Python, pixel for pixel: ``cv2.line``
(thickness 1, LINE_8), ``cv2.convexHull`` of integer points and
``cv2.fillConvexPoly`` (LINE_8, no shift), for the selftest's ddd clip
(tools/selftest.make_dataset_ddd), which JAX draws with OpenCV. Each
follows OpenCV's integer algorithm (imgproc/src/drawing.cpp: the
LineIterator with clipLine, FillConvexPoly's 16.16 fixed-point edges;
convhull.cpp: Sklansky's scan and the cyclic shift of the hull's
indices), polygons that leave the image included.
"""

from __future__ import annotations

import numpy as np

# FillConvexPoly's fixed point
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a, b):
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w, h, p1, p2):
    """``cv2.clipLine`` on a w x h image: the clipped ((x1, y1), (x2,
    y2)), or None where the segment misses the image. The second end is
    clipped with the first end's clipped value, as OpenCV does."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if (c1 | c2) != 0:
        return None
    return (x1, y1), (x2, y2)


def draw_line(img, p1, p2, color):
    """``cv2.line(img, p1, p2, color, 1, cv2.LINE_8)``: OpenCV's
    8-connected LineIterator, clipped, walked left to right."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sx = sy = 1
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    if dy < 0:
        dy = -dy
        sy = -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += -(dy + dy) + ((dx + dx) if minor else 0)
        if vert:
            y += sy
            if minor:
                x += sx
        else:
            x += sx
            if minor:
                y += sy


def fill_convex_poly(img, pts, color):
    """``cv2.fillConvexPoly(img, pts, color)``: the outline's lines, then
    one span a row between the two edges walked down from the top
    vertex, in 16.16 fixed point."""
    h, w = img.shape[:2]
    v = [(int(p[0]), int(p[1])) for p in np.asarray(pts).reshape(-1, 2)]
    n = len(v)
    if n == 0:
        return
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    p0 = v[n - 1]
    for i in range(n):
        p = v[i]
        if p[1] < ymin:
            ymin = p[1]
            imin = i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        draw_line(img, p0, p, color)
        p0 = p
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    e_idx = [imin, imin]
    e_di = [1, n - 1]
    e_x = [-XY_ONE, -XY_ONE]
    e_dx = [0, 0]
    e_ye = [ymin, ymin]
    delta1 = delta2 = XY_ONE >> 1
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0 = e_idx[i]
                di = e_di[i]
                idx = idx0 + di
                if idx >= n:
                    idx -= n
                while edges > 0:
                    edges -= 1
                    ty = v[idx][1]
                    if ty > y:
                        xs = v[idx0][0] << XY_SHIFT
                        xe = v[idx][0] << XY_SHIFT
                        e_ye[i] = ty
                        e_dx[i] = _trunc_div((xe - xs) * 2 + (ty - y),
                                             2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= n:
                        idx -= n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + delta1) >> XY_SHIFT
            xx2 = (e_x[right] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                xx1 = max(xx1, 0)
                xx2 = min(xx2, w - 1)
                if xx1 <= xx2:
                    img[y, xx1:xx2 + 1] = color
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _sklansky(pts, start, end, stack, nsign, sign2):
    """One chain of Sklansky's scan over the x-sorted points, from start
    toward end; its indices in ``stack``, returns their count."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stacksize = 3
    if start == end or (pts[start][0] == pts[end][0] and
                        pts[start][1] == pts[end][1]):
        stack[0] = start
        return 1
    stack[0], stack[1], stack[2] = pprev, pcur, pnext
    end += incr
    while pnext != end:
        cury = pts[pcur][1]
        nexty = pts[pnext][1]
        by = nexty - cury
        if (by > 0) - (by < 0) != nsign:
            ax = pts[pcur][0] - pts[pprev][0]
            bx = pts[pnext][0] - pts[pcur][0]
            ay = cury - pts[pprev][1]
            convexity = ay * bx - ax * by
            if ((convexity > 0) - (convexity < 0) == sign2 and
                    (ax != 0 or ay != 0)):
                pprev = pcur
                pcur = pnext
                pnext += incr
                stack[stacksize] = pnext
                stacksize += 1
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[stacksize - 2] = pnext
                pcur = pprev
                pprev = stack[stacksize - 4]
                stacksize -= 1
        else:
            pnext += incr
            stack[stacksize - 1] = pnext
    return stacksize - 1


def convex_hull(points, clockwise=False):
    """``cv2.convexHull(points)`` of integer points: the (n, 1, 2) int32
    hull, its vertices in OpenCV's order and starting vertex."""
    pts_in = [(int(p[0]), int(p[1]))
              for p in np.asarray(points).reshape(-1, 2)]
    total = len(pts_in)
    if total == 0:
        return np.zeros((0, 1, 2), np.int32)
    # by (x, y); std::sort is an insertion sort, stable, at this size
    order = sorted(range(total), key=lambda i: pts_in[i])
    pts = [pts_in[i] for i in order]
    miny_ind = maxy_ind = 0
    for i in range(1, total):
        y = pts[i][1]
        if pts[miny_ind][1] > y:
            miny_ind = i
        if pts[maxy_ind][1] < y:
            maxy_ind = i
    hull = []
    if pts[0] == pts[total - 1]:
        hull.append(0)
    else:
        stack = [0] * (total + 2)
        tl = [0] * (total + 2)
        tr = [0] * (total + 2)
        tl_count = _sklansky(pts, 0, maxy_ind, tl, -1, 1)
        tr_count = _sklansky(pts, total - 1, maxy_ind, tr, -1, -1)
        if not clockwise:
            tl, tr = tr, tl
            tl_count, tr_count = tr_count, tl_count
        for i in range(tl_count - 1):
            hull.append(tl[i])
        for i in range(tr_count - 1, 0, -1):
            hull.append(tr[i])
        stop_idx = (tr[1] if tr_count > 2 else
                    tl[tl_count - 2] if tl_count > 2 else -1)
        bl = [0] * (total + 2)
        br = [0] * (total + 2)
        bl_count = _sklansky(pts, 0, miny_ind, bl, 1, -1)
        br_count = _sklansky(pts, total - 1, miny_ind, br, 1, 1)
        if clockwise:
            bl, br = br, bl
            bl_count, br_count = br_count, bl_count
        if stop_idx >= 0:
            check_idx = (bl[1] if bl_count > 2 else
                         br[2 - bl_count] if bl_count + br_count > 2 else -1)
            if check_idx == stop_idx or (check_idx >= 0 and
                                         pts[check_idx] == pts[stop_idx]):
                bl_count = min(bl_count, 2)
                br_count = min(br_count, 2)
        for i in range(bl_count - 1):
            hull.append(bl[i])
        for i in range(br_count - 1, 0, -1):
            hull.append(br[i])
    idx = [order[i] for i in hull]
    nout = len(idx)
    if nout >= 3:
        min_idx = max_idx = lt = 0
        for i in range(1, nout):
            cur = idx[i]
            lt += idx[i - 1] < cur
            if lt > 1 and lt <= i - 2:
                break
            if cur < idx[min_idx]:
                min_idx = i
            if cur > idx[max_idx]:
                max_idx = i
        mmdist = abs(max_idx - min_idx)
        # OpenCV's cyclic shift toward an ascending or descending run
        if (mmdist == 1 or mmdist == nout - 1) and (
                lt <= 1 or lt >= nout - 2):
            ascending = (max_idx + 1) % nout == min_idx
            i0 = min_idx if ascending else max_idx
            j = i0
            if i0 > 0:
                tmp = []
                i = 0
                while i < nout:
                    cur = idx[j]
                    tmp.append(cur)
                    nj = j + 1 if j + 1 < nout else 0
                    if i < nout - 1 and (ascending != (cur < idx[nj])):
                        break
                    j = nj
                    i += 1
                if i == nout:
                    idx = tmp
    return np.array([pts_in[i] for i in idx], np.int32).reshape(-1, 1, 2)
